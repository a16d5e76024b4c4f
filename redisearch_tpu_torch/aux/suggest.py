# Copy of redisearch_tpu/aux/suggest.py: the port imports nothing of the JAX package.
"""Autocomplete suggestion dictionaries (FT.SUGADD/SUGGET/SUGDEL/SUGLEN).

Reference: src/suggest.c:226-341 — a standalone scored trie per key with
prefix and fuzzy (Levenshtein <= 1) completion, optional payloads, and
WITHSCORES returning a score shaped by prefix-proximity.

Host-side structure: sorted entry list + bisect prefix scan (the trie's job
on a CPU); fuzzy uses the same vectorized DP as query fuzzy expansion.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class _Entry:
    term: str
    score: float
    payload: Optional[str] = None


class SuggestionDictionary:
    """One FT.SUG* key."""

    def __init__(self):
        self._entries: dict[str, _Entry] = {}
        self._sorted: Optional[list[str]] = None

    def add(self, term: str, score: float, increment: bool = False,
            payload: Optional[str] = None) -> int:
        """FT.SUGADD; returns the dictionary size."""
        cur = self._entries.get(term)
        if cur is not None:
            cur.score = cur.score + score if increment else score
            if payload is not None:
                cur.payload = payload
        else:
            self._entries[term] = _Entry(term, score, payload)
            self._sorted = None
        return len(self._entries)

    def delete(self, term: str) -> bool:
        if term in self._entries:
            del self._entries[term]
            self._sorted = None
            return True
        return False

    def __len__(self) -> int:
        return len(self._entries)

    def _terms(self) -> list[str]:
        if self._sorted is None:
            self._sorted = sorted(self._entries)
        return self._sorted

    def get(self, prefix: str, fuzzy: bool = False, max_results: int = 5,
            with_scores: bool = False, with_payloads: bool = False):
        """FT.SUGGET.  Returns list of terms, or (term, score[, payload])
        tuples.  Fuzzy adds prefixes within edit distance 1 (reference
        behavior: fuzzy on the *prefix*)."""
        terms = self._terms()
        cands: dict[str, float] = {}

        def scan(pfx: str, dist: int):
            lo = bisect.bisect_left(terms, pfx)
            for i in range(lo, len(terms)):
                t = terms[i]
                if not t.startswith(pfx):
                    break
                e = self._entries[t]
                # exact reference score shaping (src/trie/trie.c:271-279):
                # a candidate equal to the query string scores INT_MAX;
                # fuzzy iteration multiplies by exp(-2*dist); prefix mode
                # divides by sqrt(1 + |len(candidate) - len(query)|)
                s = float(2**31 - 1) if t == prefix else e.score
                if fuzzy:
                    s *= math.exp(-2.0 * dist)
                s /= math.sqrt(1.0 + abs(len(t) - len(prefix)))
                if t not in cands or s > cands[t]:
                    cands[t] = s

        scan(prefix, 0)
        if fuzzy and prefix:
            for pfx in _edits1(prefix):
                if pfx != prefix:
                    scan(pfx, 1)

        ranked = sorted(cands.items(), key=lambda kv: (-kv[1], kv[0]))
        out = []
        for t, s in ranked[:max_results]:
            row = [t]
            if with_scores:
                row.append(s)
            if with_payloads:
                row.append(self._entries[t].payload)
            out.append(tuple(row) if len(row) > 1 else t)
        return out


def _edits1(word: str) -> set[str]:
    """All strings within edit distance 1 (deletes/transposes/replaces/
    inserts over the observed alphabet)."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    splits = [(word[:i], word[i:]) for i in range(len(word) + 1)]
    out = set()
    for l, r in splits:
        if r:
            out.add(l + r[1:])                      # delete
            for c in letters:
                out.add(l + c + r[1:])              # replace
        if len(r) > 1:
            out.add(l + r[1] + r[0] + r[2:])        # transpose
        for c in letters:
            out.add(l + c + r)                      # insert
    return out
