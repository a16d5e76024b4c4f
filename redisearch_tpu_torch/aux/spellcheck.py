# Copy of redisearch_tpu/aux/spellcheck.py: the port imports nothing of the JAX package.
"""Spelling correction (FT.SPELLCHECK) + custom dictionaries (FT.DICT*).

Reference: src/spell_check.c, src/dictionary.c — for each query term, scan
the term trie for candidates within Levenshtein distance <= 4 (configurable
1..4), plus TERMS INCLUDE/EXCLUDE dictionaries; candidates scored by their
document frequency over total docs.

Here the trie scan becomes the vectorized Levenshtein sweep from
query/expand.py over the segment term dictionaries.
"""

from __future__ import annotations

from typing import Optional

from ..analysis.tokenizer import Tokenizer, normalize_token
from ..query import ast
from ..query.expand import STEM_PREFIX, PHONETIC_PREFIX, expand_fuzzy
from ..utils.errors import IndexError_


class Dictionary:
    """FT.DICTADD/DICTDEL/DICTDUMP — named term sets."""

    def __init__(self):
        self._dicts: dict[str, set[str]] = {}

    def add(self, name: str, *terms: str) -> int:
        d = self._dicts.setdefault(name, set())
        n = 0
        for t in terms:
            t = t.lower()
            if t not in d:
                d.add(t)
                n += 1
        return n

    def delete(self, name: str, *terms: str) -> int:
        d = self._dicts.get(name)
        if d is None:
            return 0
        n = 0
        for t in terms:
            if t.lower() in d:
                d.discard(t.lower())
                n += 1
        return n

    def dump(self, name: str) -> list[str]:
        d = self._dicts.get(name)
        if d is None:
            raise IndexError_(f"could not open dict key {name}")
        return sorted(d)

    def get(self, name: str) -> set[str]:
        return self._dicts.get(name, set())


def spellcheck(
    index,
    query: str,
    distance: int = 1,
    include: Optional[list[str]] = None,
    exclude: Optional[list[str]] = None,
    dicts: Optional[Dictionary] = None,
    max_suggestions: int = 10,
) -> list[dict]:
    """FT.SPELLCHECK analog.

    Returns [{"term": t, "suggestions": [(score, suggestion), ...]}] for
    each misspelled query term, mirroring the reference reply shape.
    """
    if not 1 <= distance <= 4:
        raise IndexError_("distance must be in [1, 4]")
    index.commit()
    exclude_terms: set[str] = set()
    include_terms: set[str] = set()
    if dicts is not None:
        for name in exclude or []:
            exclude_terms |= dicts.get(name)
        for name in include or []:
            include_terms |= dicts.get(name)

    # collect query terms (parse; fall back to tokenization on syntax-light
    # input like the reference's spellcheck of raw token streams)
    try:
        root = index.parse_query(query)
        terms = [n.term for n in ast.walk(root)
                 if isinstance(n, ast.TokenNode)]
    except Exception:
        terms = [t.tok for t in Tokenizer(index.stopwords).tokenize(query)]

    total_docs = max(index.doctable.num_docs, 1)
    out = []
    for term in terms:
        term = normalize_token(term)
        df = _doc_freq(index, term)
        if df > 0 or term in exclude_terms:
            continue  # spelled correctly
        cands: dict[str, float] = {}
        for seg in index.segments:
            for t in expand_fuzzy(seg.terms, term, distance,
                                  max_expansions=512):
                if t.startswith((STEM_PREFIX, PHONETIC_PREFIX, "~")):
                    continue
                if t in exclude_terms:
                    continue
                score = _doc_freq(index, t) / total_docs
                cands[t] = max(cands.get(t, 0.0), score)
        for t in include_terms:
            if t not in cands and _lev_le(term, t, distance):
                cands[t] = 0.0
        ranked = sorted(cands.items(), key=lambda kv: (-kv[1], kv[0]))
        out.append({
            "term": term,
            "suggestions": [(s, t) for t, s in ranked[:max_suggestions]],
        })
    return out


def _doc_freq(index, term: str) -> int:
    df = 0
    for seg in index.segments:
        tid = seg.terms.lookup(term)
        if tid >= 0:
            df += int(seg.terms.doc_freq[tid])
    return df


def _lev_le(a: str, b: str, d: int) -> bool:
    if abs(len(a) - len(b)) > d:
        return False
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1] <= d
