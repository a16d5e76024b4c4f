# Copy of redisearch_tpu/agg/reducers.py: the port imports nothing of the JAX package.
"""GROUPBY reducers (reference: src/aggregate/reducers/, reducer.c:26-40).

Each reducer is an accumulator object with add(row_value)/finalize(), plus a
`distribute()` classmethod describing how the coordinator splits it across
shards (reference: dist_plan.cpp:480-497 per-reducer rewrites) — used by the
distributed aggregation layer.
"""

from __future__ import annotations

import random
from typing import Any, Optional

from ..utils.errors import QuerySyntaxError
from ..utils.hll import HLL
from .expr import NULL, _num


class Reducer:
    NAME = ""

    def __init__(self, *args: str):
        self.args = args
        self.prop = args[0].lstrip("@") if args else None

    def add(self, row: dict):
        raise NotImplementedError

    def finalize(self):
        raise NotImplementedError

    def default_alias(self) -> str:
        a = "_".join(x.lstrip("@") for x in self.args)
        return f"__generated_alias{self.NAME.lower()}_{a}" if a else \
            f"__generated_alias{self.NAME.lower()}"


class RCount(Reducer):
    NAME = "COUNT"

    def __init__(self, *args):
        super().__init__(*args)
        self.n = 0

    def add(self, row):
        self.n += 1

    def finalize(self):
        return float(self.n)


class RSum(Reducer):
    NAME = "SUM"

    def __init__(self, *args):
        super().__init__(*args)
        self.s = 0.0

    def add(self, row):
        v = _num(row.get(self.prop))
        if v is not None:
            self.s += v

    def finalize(self):
        return self.s


class RMin(Reducer):
    NAME = "MIN"

    def __init__(self, *args):
        super().__init__(*args)
        self.v: Optional[float] = None

    def add(self, row):
        v = _num(row.get(self.prop))
        if v is not None and (self.v is None or v < self.v):
            self.v = v

    def finalize(self):
        return self.v if self.v is not None else NULL


class RMax(Reducer):
    NAME = "MAX"

    def __init__(self, *args):
        super().__init__(*args)
        self.v: Optional[float] = None

    def add(self, row):
        v = _num(row.get(self.prop))
        if v is not None and (self.v is None or v > self.v):
            self.v = v

    def finalize(self):
        return self.v if self.v is not None else NULL


class RAvg(Reducer):
    NAME = "AVG"

    def __init__(self, *args):
        super().__init__(*args)
        self.s = 0.0
        self.n = 0

    def add(self, row):
        v = _num(row.get(self.prop))
        if v is not None:
            self.s += v
            self.n += 1

    def finalize(self):
        return self.s / self.n if self.n else NULL


class RStdDev(Reducer):
    NAME = "STDDEV"

    def __init__(self, *args):
        super().__init__(*args)
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, row):
        v = _num(row.get(self.prop))
        if v is None:
            return
        self.n += 1
        d = v - self.mean
        self.mean += d / self.n
        self.m2 += d * (v - self.mean)

    def finalize(self):
        if self.n < 2:
            return 0.0 if self.n else NULL
        return (self.m2 / (self.n - 1)) ** 0.5


class RSumSq(Reducer):
    """Internal: sum of squares (distributed STDDEV shard partial)."""
    NAME = "SUMSQ"

    def __init__(self, *args):
        super().__init__(*args)
        self.s = 0.0

    def add(self, row):
        v = _num(row.get(self.prop))
        if v is not None:
            self.s += v * v

    def finalize(self):
        return self.s


class RCountDistinct(Reducer):
    NAME = "COUNT_DISTINCT"

    def __init__(self, *args):
        super().__init__(*args)
        self.seen: set = set()

    def add(self, row):
        v = row.get(self.prop)
        if v is not NULL:
            self.seen.add(_hashable(v))

    def finalize(self):
        return float(len(self.seen))


class RCountDistinctish(Reducer):
    NAME = "COUNT_DISTINCTISH"

    def __init__(self, *args):
        super().__init__(*args)
        self.hll = HLL()

    def add(self, row):
        v = row.get(self.prop)
        if v is not NULL:
            self.hll.add(_hashable(v))

    def finalize(self):
        return float(self.hll.count())


class RHLL(RCountDistinctish):
    """Returns the serialized HLL registers (mergeable downstream)."""
    NAME = "HLL"

    def finalize(self):
        return self.hll.to_bytes()


class RHLLSum(Reducer):
    """Merges serialized HLLs (coordinator side of distributed
    COUNT_DISTINCTISH)."""
    NAME = "HLL_SUM"

    def __init__(self, *args):
        super().__init__(*args)
        self.hll = HLL()

    def add(self, row):
        v = row.get(self.prop)
        if isinstance(v, bytes):
            self.hll.merge(HLL.from_bytes(v))

    def finalize(self):
        return float(self.hll.count())


class RToList(Reducer):
    NAME = "TOLIST"

    def __init__(self, *args):
        super().__init__(*args)
        self.vals: list = []
        self._seen: set = set()

    def add(self, row):
        v = row.get(self.prop)
        if v is NULL:
            return
        for item in (v if isinstance(v, list) else [v]):
            h = _hashable(item)
            if h not in self._seen:
                self._seen.add(h)
                self.vals.append(item)

    def finalize(self):
        return self.vals


class RFirstValue(Reducer):
    """FIRST_VALUE <prop> [BY <sortprop> [ASC|DESC]]"""
    NAME = "FIRST_VALUE"

    def __init__(self, *args):
        super().__init__(*args)
        self.by = None
        self.asc = True
        a = list(args)
        if len(a) >= 3 and a[1].upper() == "BY":
            self.by = a[2].lstrip("@")
            if len(a) >= 4 and a[3].upper() in ("ASC", "DESC"):
                self.asc = a[3].upper() == "ASC"
        self.best_key = None
        self.val = NULL
        self.has = False

    def add(self, row):
        v = row.get(self.prop)
        if self.by is None:
            if not self.has:
                self.val = v
                self.has = True
            return
        k = _num(row.get(self.by))
        if k is None:
            return
        if (self.best_key is None
                or (k < self.best_key if self.asc else k > self.best_key)):
            self.best_key = k
            self.val = v
            self.has = True

    def finalize(self):
        return self.val


class RRandomSample(Reducer):
    """RANDOM_SAMPLE <prop> <n> — reservoir sampling."""
    NAME = "RANDOM_SAMPLE"

    def __init__(self, *args):
        super().__init__(*args)
        self.n = int(args[1]) if len(args) > 1 else 1
        self.seen = 0
        self.sample: list = []
        self._rng = random.Random(0xC0FFEE)

    def add(self, row):
        v = row.get(self.prop)
        if v is NULL:
            return
        self.seen += 1
        if len(self.sample) < self.n:
            self.sample.append(v)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.n:
                self.sample[j] = v

    def finalize(self):
        return self.sample


class RQuantile(Reducer):
    """QUANTILE <prop> <q>"""
    NAME = "QUANTILE"

    def __init__(self, *args):
        super().__init__(*args)
        self.q = float(args[1]) if len(args) > 1 else 0.5
        self.vals: list[float] = []

    def add(self, row):
        v = _num(row.get(self.prop))
        if v is not None:
            self.vals.append(v)

    def finalize(self):
        if not self.vals:
            return NULL
        s = sorted(self.vals)
        # reference uses nearest-rank on the lower side
        idx = min(int(self.q * len(s)), len(s) - 1)
        return s[idx]


class RCollect(RToList):
    NAME = "COLLECT"


REDUCERS: dict[str, type] = {
    r.NAME: r for r in [
        RCount, RSum, RSumSq, RMin, RMax, RAvg, RStdDev, RCountDistinct,
        RCountDistinctish, RHLL, RHLLSum, RToList, RFirstValue,
        RRandomSample, RQuantile, RCollect,
    ]
}


def make_reducer(name: str, args: list[str]) -> Reducer:
    cls = REDUCERS.get(name.upper())
    if cls is None:
        raise QuerySyntaxError(f"Unknown reducer {name!r}")
    return cls(*args)


def _hashable(v):
    if isinstance(v, list):
        return tuple(v)
    return v
