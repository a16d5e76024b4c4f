# Copy of redisearch_tpu/utils/hll.py: the port imports nothing of the JAX package.
"""HyperLogLog cardinality estimation (reference: deps/hll, Rust
hyperloglog crate — used by COUNT_DISTINCTISH and the HLL/HLL_SUM reducers).

Dense u8 register array + max-merge; numpy-vectorized add path.  Register
layout matches the classic HLL paper (2^p registers of 6 effective bits);
estimates use the bias-corrected formula with small/large range corrections.
"""

from __future__ import annotations

import hashlib

import numpy as np


class HLL:
    __slots__ = ("p", "m", "regs")

    def __init__(self, p: int = 14):
        self.p = p
        self.m = 1 << p
        self.regs = np.zeros(self.m, np.uint8)

    @staticmethod
    def _hash64(value) -> int:
        b = str(value).encode("utf-8", "surrogatepass")
        return int.from_bytes(hashlib.sha1(b).digest()[:8], "little")

    def add(self, value) -> None:
        h = self._hash64(value)
        idx = h & (self.m - 1)
        w = h >> self.p
        rank = (64 - self.p) - w.bit_length() + 1 if w else (64 - self.p) + 1
        if rank > self.regs[idx]:
            self.regs[idx] = rank

    def merge(self, other: "HLL") -> None:
        np.maximum(self.regs, other.regs, out=self.regs)

    def count(self) -> int:
        m = float(self.m)
        est = _alpha(self.m) * m * m / np.sum(
            np.exp2(-self.regs.astype(np.float64)))
        if est <= 2.5 * m:
            zeros = int(np.sum(self.regs == 0))
            if zeros:
                est = m * np.log(m / zeros)
        elif est > (1 << 64) / 30.0:
            est = -(1 << 64) * np.log(1.0 - est / (1 << 64))
        return int(round(est))

    def to_bytes(self) -> bytes:
        return self.regs.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, p: int = 14) -> "HLL":
        h = cls(p)
        h.regs = np.frombuffer(data, np.uint8).copy()
        return h


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)
