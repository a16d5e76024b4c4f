# Copy of redisearch_tpu/ext.py: the port imports nothing of the JAX package.
"""Extension API: pluggable scorers and query expanders.

Reference: the EXTLOAD mechanism (src/extension.c) lets dynamically loaded
extensions register scorers and query expanders; the default extension
registers the built-ins (ext/default.c:767-806).

Here extensions are Python callables registered at runtime:

    import redisearch_tpu.ext as ext

    @ext.expander("MYEXP")
    def my_expander(token: str) -> list[str]:
        return [token, token[::-1]]          # index terms to union

    @ext.scorer("MYSCORE")
    def my_scorer(key, fields, base_score) -> float:
        return base_score * fields.get("boost", 1.0)

Custom expanders replace the default stemmer/synonym/phonetic chain for
non-verbatim tokens.  Custom scorers re-rank on the host: the engine
retrieves an over-fetched candidate set with BM25STD and the callable
assigns the final score — the analog of the reference's per-document
scorer callback (which also runs scalar code per candidate).
"""

from __future__ import annotations

from typing import Callable, Optional

_EXPANDERS: dict[str, Callable[[str], list[str]]] = {}
_SCORERS: dict[str, Callable] = {}

#: over-fetch factor for host re-scoring (candidates = factor * num)
RESCORE_FACTOR = 8

BUILTIN_SCORERS = ("TFIDF", "TFIDF.DOCNORM", "BM25", "BM25STD",
                   "BM25STD.TANH", "DISMAX", "DOCSCORE", "HAMMING")


def expander(name: str):
    def deco(fn):
        register_expander(name, fn)
        return fn
    return deco


def scorer(name: str):
    def deco(fn):
        register_scorer(name, fn)
        return fn
    return deco


def register_expander(name: str, fn: Callable[[str], list[str]]) -> None:
    _EXPANDERS[name.upper()] = fn


def register_scorer(name: str, fn: Callable) -> None:
    _SCORERS[name.upper()] = fn


def get_expander(name: Optional[str]):
    return _EXPANDERS.get(name.upper()) if name else None


def get_scorer(name: Optional[str]):
    return _SCORERS.get(name.upper()) if name else None


def is_custom_scorer(name: Optional[str]) -> bool:
    return bool(name) and name.upper() not in BUILTIN_SCORERS \
        and name.upper() in _SCORERS
