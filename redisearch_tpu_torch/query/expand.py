# Copy of redisearch_tpu/query/expand.py: the port imports nothing of the JAX package.
"""Query expansion: stemmer/synonym/phonetic expanders + term-dictionary
expansion of prefix/suffix/infix, fuzzy and wildcard patterns.

Reference: QAST_Expand + the default extension's expanders
(src/ext/default.c:788-806: StemmerExpander/SynonymExpand/PhoneticExpand),
and the eval-time trie expansion of affix/fuzzy/wildcard nodes
(query_eval/src/nodes/prefix.rs, src/query.c fuzzy/wildcard eval).

On TPU the term dictionary stays host-side (SURVEY.md §7.3).  Affix
expansion uses bisect over the sorted term list (prefix) and suffix/infix
scans; fuzzy uses a numpy-vectorized Levenshtein DP over a codepoint matrix
of all terms at once (replacing the trie sparse-automaton of
src/trie/levenshtein.c with a data-parallel sweep).
"""

from __future__ import annotations

import bisect
import fnmatch
import re
from typing import Optional

import numpy as np

from .. import native as _native

from ..analysis.phonetics import dm_code
from ..analysis.stemmer import Stemmer
from ..analysis.synonyms import SynonymMap
from ..index.segment import TermDict

STEM_PREFIX = "+"
PHONETIC_PREFIX = "\x01"

# Reference defaults (config.h:410): MAXPREFIXEXPANSIONS=200, MINPREFIX=2.
DEFAULT_MAX_EXPANSIONS = 200
DEFAULT_MIN_PREFIX = 2


def expand_token(
    term: str,
    verbatim: bool,
    stemmer: Optional[Stemmer],
    synonyms: Optional[SynonymMap],
    phonetic: bool,
) -> list[str]:
    """Default-expander chain for one query token."""
    out = [term]
    if verbatim:
        return out
    if stemmer is not None:
        st = stemmer.stem(term)
        if st:
            out.append(STEM_PREFIX + st)
            # the reference also expands the BARE stem when it differs
            # from the token (ext/default.c:617-619) so "running"
            # matches docs containing just "run" (which index no
            # '+run' entry — stems equal to their token are not
            # forward-indexed)
            out.append(st)
        else:
            # token is its own stem: match docs whose tokens stem to it
            out.append(STEM_PREFIX + term)
    if synonyms is not None:
        out.extend(synonyms.group_terms(term))
    if phonetic:
        code = dm_code(term)
        if code:
            out.append(PHONETIC_PREFIX + code)
    # dedupe, preserve order
    seen = set()
    res = []
    for t in out:
        if t not in seen:
            seen.add(t)
            res.append(t)
    return res


# ---------------------------------------------------------------------------
# Dictionary expansion
# ---------------------------------------------------------------------------

def expand_prefix(sorted_terms: list[str], prefix: str,
                  max_expansions: int = DEFAULT_MAX_EXPANSIONS) -> list[str]:
    """All dictionary terms starting with `prefix` (bounded)."""
    lo = bisect.bisect_left(sorted_terms, prefix)
    out = []
    for i in range(lo, len(sorted_terms)):
        t = sorted_terms[i]
        if not t.startswith(prefix):
            break
        out.append(t)
        if len(out) >= max_expansions:
            break
    return out


def expand_affix(sorted_terms: list[str], text: str, prefix: bool,
                 suffix: bool,
                 max_expansions: int = DEFAULT_MAX_EXPANSIONS) -> list[str]:
    """prefix* / *suffix / *infix* expansion (reference: suffix trie,
    src/suffix.c; here a bounded scan — terms with reserved prefixes
    (stem '+', phonetic '\\x01', synonym '~') are excluded)."""
    if prefix and not suffix:
        return [t for t in expand_prefix(sorted_terms, text,
                                         max_expansions)]
    out = []
    for t in sorted_terms:
        if t and t[0] in (STEM_PREFIX, PHONETIC_PREFIX, "~"):
            continue
        if prefix and suffix:      # *infix*
            if text in t:
                out.append(t)
        elif suffix:               # *suffix
            if t.endswith(text):
                out.append(t)
        if len(out) >= max_expansions:
            break
    return out


def expand_wildcard(sorted_terms: list[str], pattern: str,
                    max_expansions: int = DEFAULT_MAX_EXPANSIONS) -> list[str]:
    """w'...' glob expansion: * any seq, ? single char (src/wildcard/)."""
    rx = re.compile(fnmatch.translate(pattern))
    out = []
    # constant prefix of the pattern bounds the scan
    const = re.split(r"[*?\[]", pattern, 1)[0]
    lo = bisect.bisect_left(sorted_terms, const) if const else 0
    for i in range(lo, len(sorted_terms)):
        t = sorted_terms[i]
        if const and not t.startswith(const):
            break
        if t and t[0] in (STEM_PREFIX, PHONETIC_PREFIX, "~"):
            continue
        if rx.match(t):
            out.append(t)
            if len(out) >= max_expansions:
                break
    return out


_blob_caches: dict[int, tuple] = {}


def _term_blob(td: TermDict) -> bytes:
    """NUL-separated term blob for native scans (cached per dictionary)."""
    key = id(td)
    c = _blob_caches.get(key)
    if c is None or c[0] is not td.terms:
        blob = "\0".join(td.terms).encode("utf-8", "surrogatepass") + b"\0"
        c = (td.terms, blob)
        _blob_caches[key] = c
    return c[1]


class _FuzzyCache:
    """Codepoint matrix over a TermDict for vectorized Levenshtein."""

    __slots__ = ("mat", "lens", "terms")

    def __init__(self, terms: list[str], max_len: int = 32):
        n = len(terms)
        self.terms = terms
        self.lens = np.zeros(n, np.int32)
        self.mat = np.zeros((n, max_len), np.uint32)
        for i, t in enumerate(terms):
            cps = [ord(c) for c in t[:max_len]]
            self.lens[i] = len(t)
            self.mat[i, :len(cps)] = cps


_fuzzy_caches: dict[int, _FuzzyCache] = {}


def _fuzzy_cache(td: TermDict) -> _FuzzyCache:
    key = id(td)
    c = _fuzzy_caches.get(key)
    if c is None or c.terms is not td.terms:
        c = _FuzzyCache(td.terms)
        _fuzzy_caches[key] = c
    return c


def expand_fuzzy(td: TermDict, term: str, max_dist: int,
                 max_expansions: int = DEFAULT_MAX_EXPANSIONS) -> list[str]:
    """Terms within Levenshtein distance <= max_dist of `term`.

    Vectorized DP over all dictionary terms at once (the data-parallel
    replacement of the trie Levenshtein automaton, src/trie/levenshtein.c).
    """
    if _native.available():
        idx = _native.term_scan("fuzzy", _term_blob(td), term,
                                max_expansions * 4, max_dist)
        out = []
        for i in idx.tolist():
            t = td.terms[i]
            if t and t[0] in (STEM_PREFIX, PHONETIC_PREFIX, "~"):
                continue
            out.append(t)
            if len(out) >= max_expansions:
                break
        return out
    cache = _fuzzy_cache(td)
    n, Lmax = cache.mat.shape
    if n == 0:
        return []
    q = np.array([ord(c) for c in term[:Lmax]], np.uint32)
    m = len(q)
    # length pruning
    cand = np.abs(cache.lens - m) <= max_dist
    idxs = np.nonzero(cand)[0]
    if idxs.size == 0:
        return []
    mat = cache.mat[idxs]
    lens = cache.lens[idxs]
    k = idxs.size
    width = min(Lmax, m + max_dist)
    # DP rows over query chars; D has shape [k, width+1]
    D = np.broadcast_to(np.arange(width + 1, dtype=np.int32),
                        (k, width + 1)).copy()
    for i in range(1, m + 1):
        prev = D
        D = np.empty_like(prev)
        D[:, 0] = i
        sub_cost = (mat[:, :width] != q[i - 1]).astype(np.int32)
        # vectorize the j loop via cumulative min is tricky; width is small
        for j in range(1, width + 1):
            D[:, j] = np.minimum(
                np.minimum(prev[:, j] + 1, D[:, j - 1] + 1),
                prev[:, j - 1] + sub_cost[:, j - 1])
    final = D[np.arange(k), np.minimum(lens, width)]
    ok = final <= max_dist
    hits = idxs[ok]
    out = []
    for i in hits[:max_expansions * 4]:
        t = cache.terms[i]
        if t and t[0] in (STEM_PREFIX, PHONETIC_PREFIX, "~"):
            continue
        out.append(t)
        if len(out) >= max_expansions:
            break
    return out
