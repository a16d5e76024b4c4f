"""The general traffic generator: a mix file (`mixes/<name>.json`) is
data that this module reads.

A mix names its entry (`entries/<entry>.py`), its batch, and its query
families, each with a weight and a query template.  A template's `<slot>`
takes a value drawn from the mix's `slots`, fresh for every query:

* `{"draw": "tag", "field": F}`: one of F's labels, drawn with the
  labels' own shares of the documents (a query asks for the label of a
  document drawn at random);
* `{"draw": "int_range", "lo": a, "hi": b, "min_width": w0,
  "max_width": w1}`: "x x+w" with the width w uniform in [w0, w1] and x
  uniform in [a, b - w], so every range lies inside [a, b];
* `{"draw": "term", "field": F, "lo": r0, "hi": r1}`: a word of TEXT
  field F's vocabulary of a rank in [r0, r1), uniform over the ranks, or
  with `"by": "share"` by the words' shares of F's drawn tokens inside
  that range.  Where a template uses one term slot more than once, the
  words of one query differ.

A family's `vector` (`{"field": F, "param": "b"}`) gives each query a
fresh query vector of F's dimension, unit normal entries, as the PARAMS
blob `param`.  Batch b's draws come from streams seeded by (seed, b), so
a batch is the same whatever happened before it; warm-up batches come
from streams of their own.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from .corpus import generator, stream_seed

_SLOT = re.compile(r"<(\w+)>")
WARM_STREAM, BATCH_STREAM, VECTOR_STREAM = 71, 72, 73


@dataclasses.dataclass
class Batch:
    """One batch of requests: each query's family, its template text
    with the slots filled, and its PARAMS (None where it has none)."""
    families: list
    queries: list
    params: list
    vectors: list        # the query vector of each query, or None

    def __len__(self) -> int:
        return len(self.queries)


class Traffic:
    def __init__(self, mix: dict, ds, seed: int):
        self.mix, self.ds, self.seed = mix, ds, seed
        self.fams = mix["families"]
        w = np.array([f.get("weight", 1.0) for f in self.fams], float)
        self.p = w / w.sum()
        self.parts = [_SLOT.split(f["query"]) for f in self.fams]
        # each tag or term slot's values and their shares, built once:
        # not inside the window
        self.values = {}
        for name, spec in mix.get("slots", {}).items():
            if spec["draw"] == "tag":
                self.values[name] = (
                    np.array(ds.tag_values(spec["field"]), dtype=object),
                    ds.tag_weights(spec["field"]))
            elif spec["draw"] == "term":
                self.values[name] = _term_values(ds.texts[spec["field"]],
                                                 spec)

    def batch(self, b: int, warm: bool = False) -> Batch:
        stream = WARM_STREAM if warm else BATCH_STREAM
        rng = np.random.default_rng(stream_seed(self.seed, stream, b))
        n = self.mix["batch"]
        fam = rng.choice(len(self.fams), size=n, p=self.p)
        queries = np.empty(n, object)
        for j, parts in enumerate(self.parts):
            at = np.flatnonzero(fam == j)
            if len(at):
                queries[at] = self._fill(parts, len(at), rng)
        vectors = [None] * n
        params = [None] * n
        gv = None
        for j, f in enumerate(self.fams):
            vec = f.get("vector")
            at = np.flatnonzero(fam == j)
            if vec is None or not len(at):
                continue
            if gv is None:
                gv = generator(self.ds.dev, self.seed, VECTOR_STREAM,
                               int(warm), b)
            dim = self.ds.field(vec["field"])["dim"]
            v = torch.randn(len(at), dim, generator=gv, device=self.ds.dev,
                            dtype=torch.float32).cpu().numpy()
            for i, row in zip(at.tolist(), v):
                vectors[i] = row
                if "param" in vec:
                    params[i] = {vec["param"]: row}
        return Batch(families=fam.tolist(),
                     queries=queries.tolist(),
                     params=params if any(p is not None for p in params)
                     else None, vectors=vectors)

    def _fill(self, parts: list, m: int, rng) -> list:
        slots = parts[1::2]
        values = {}
        for name in dict.fromkeys(slots):
            k = slots.count(name)
            values[name] = self._draw(name, m, k, rng)
        used = dict.fromkeys(values, 0)
        acc = np.full(m, parts[0], dtype=object)
        for i, name in enumerate(slots):
            acc = acc + values[name][:, used[name]] + parts[2 * i + 2]
            used[name] += 1
        return acc.tolist()

    def _draw(self, name: str, m: int, k: int, rng) -> np.ndarray:
        """[m, k] object array of slot values."""
        spec = self.mix["slots"][name]
        draw = spec["draw"]
        if draw == "tag":
            vals, p = self.values[name]
            return vals[rng.choice(len(vals), size=(m, k), p=p)]
        if draw == "int_range":
            w = rng.integers(spec["min_width"], spec["max_width"] + 1,
                             size=m * k)
            x = spec["lo"] + (rng.random(m * k) * (spec["hi"] - spec["lo"]
                                                   - w + 1)).astype(np.int64)
            return np.array([f"{a} {a + b}" for a, b in zip(x.tolist(),
                                                          w.tolist())],
                            dtype=object).reshape(m, k)
        if draw == "term":
            vals, p = self.values[name]
            return vals[_distinct_rows(rng, len(vals), p, m, k)]
        raise ValueError(f"unknown slot draw {draw!r}")


def _term_values(text, spec: dict) -> tuple:
    """(words of ranks [lo, hi), their probabilities or None: uniform)."""
    lo, hi = spec["lo"], spec["hi"]
    words = text.words[lo:hi]
    by = spec.get("by", "rank")
    if by == "rank":
        return words, None
    if by != "share":
        raise ValueError(f"term slot: unknown 'by' {by!r}")
    counts = np.bincount(text.ids, minlength=len(text.words))[lo:hi]
    return words, counts / counts.sum()


def _distinct_rows(rng, n: int, p, m: int, k: int) -> np.ndarray:
    """[m, k] indices into n values, drawn with probabilities p (None:
    uniform), the k of a row all different: a value that repeats one
    earlier in its row is drawn again."""
    if k > n:
        raise ValueError(f"{k} distinct values asked of {n}")

    def draw(size):
        return rng.choice(n, size=size, p=p)
    idx = draw((m, k))
    while True:
        dup = np.zeros((m, k), bool)
        for j in range(1, k):
            dup[:, j] = (idx[:, :j] == idx[:, j:j + 1]).any(axis=1)
        if not dup.any():
            return idx
        idx[dup] = draw(int(dup.sum()))
