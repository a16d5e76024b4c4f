# Copy of redisearch_tpu/analysis/stopwords.py: the port imports nothing of the JAX package.
"""Stopword lists (reference: src/stopwords.c, src/default_stopwords.h).

The default list matches the reference's DEFAULT_STOPWORDS.
"""

from __future__ import annotations

from typing import Iterable, Optional

DEFAULT_STOPWORDS = frozenset(
    """a is the an and are as at be but by for if in into it no not of on or
    such that their then there these they this to was will with""".split()
)


class StopWordList:
    """Per-index stopword set (reference: StopWordList, src/stopwords.c)."""

    def __init__(self, words: Optional[Iterable[str]] = None):
        if words is None:
            self._words = DEFAULT_STOPWORDS
        else:
            self._words = frozenset(w.lower() for w in words)

    def contains(self, token: str) -> bool:
        return token.lower() in self._words

    def __contains__(self, token: str) -> bool:
        return self.contains(token)

    def __iter__(self):
        return iter(sorted(self._words))

    def __len__(self):
        return len(self._words)
