"""The comparison that decides `correct`: served answers against the
plain reference's, one query at a time, and the numbers it yields.

Per query, for a ranked list of hits: by distance, nearest first (a
KNN query, lower is better), or by score, highest first (any other
query, higher is better):

* `rank_gap`: at each rank j, how far the reference's value of the
  served document lies behind the reference's own j-th value: for
  distances the difference, for scores the difference over the
  reference's j-th score.  A served document that does not match, or a
  rank that one side has and the other lacks, reads 1.
* `tie_order_err`: ranks whose served document differs from the
  reference's although the two documents' reference values are equal
  (a tie broken otherwise than by ascending document id).
* `dist_err`: the largest gap between a hit's served distance and the
  reference's distance of the same document.
* `score_err`: the largest relative error of a hit's served score
  against the reference's score of the same document, |served - ref| /
  |ref|.
* `total_err`: 1 where the served total differs from the reference's.

Across the sample each number is the largest, or for counts the sum.
"""

from __future__ import annotations

import numpy as np

WORST = 1.0
#: how the numbers of one query combine over the sample
COMBINE = {"total_err": "sum", "tie_order_err": "sum", "rank_gap": "max",
           "dist_err": "max", "score_err": "max"}


def ranked(ref, value_of, ranked_rows: list, served: list,
           better: str = "lower") -> dict:
    """Judge one ranked answer.  `value_of(row)` is the reference's
    value (distance or score) of a row that matches (None for another
    row), `ranked_rows` the reference's answer, `served` [(key, served
    value)] in served order, `better` "lower" (distances: `dist_err`) or
    "higher" (scores: `score_err`)."""
    if better == "lower":
        err_name = "dist_err"

        def behind(w, r):
            return r - w

        def off(v, r):
            return abs(v - r)
    else:
        err_name = "score_err"

        def behind(w, r):
            return (w - r) / (abs(w) or 1.0)

        def off(v, r):
            return abs(v - r) / (abs(r) or 1.0)
    want = [value_of(r) for r in ranked_rows]
    gap, ties, err = 0.0, 0, 0.0
    for j in range(max(len(served), len(ranked_rows))):
        if j >= len(served) or j >= len(ranked_rows):
            gap = WORST
            continue
        key, v = served[j]
        row = ref.key_row(key)
        r = value_of(row) if row >= 0 else None
        if r is None or v is None:
            gap = WORST
            continue
        gap = max(gap, behind(want[j], r))
        if row != ranked_rows[j] and r == want[j]:
            ties += 1
        err = max(err, off(v, r))
    return {"rank_gap": gap, "tie_order_err": ties, err_name: err}


def combine(per_query: list) -> dict:
    out: dict = {}
    for nums in per_query:
        for k, v in nums.items():
            if k not in out:
                out[k] = v
            elif COMBINE[k] == "sum":
                out[k] += v
            else:
                out[k] = max(out[k], v)
    return out


def lookup(rows: np.ndarray, values: np.ndarray):
    """value_of over ascending `rows` and their `values`."""
    def value_of(row):
        at = int(np.searchsorted(rows, row))
        if at < len(rows) and rows[at] == row:
            return float(values[at])
        return None
    return value_of
