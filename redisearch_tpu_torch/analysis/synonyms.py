# Copy of redisearch_tpu/analysis/synonyms.py: the port imports nothing of the JAX package.
"""Synonym map (reference: src/synonym_map.c).

Same design as the reference: FT.SYNUPDATE assigns terms to numbered groups;
at *index* time a token belonging to group g is additionally indexed under
the virtual term "~g"; at *query* time the default expander expands a token
in group g to include "~g".  Documents indexed before a SYNUPDATE therefore
don't match new synonyms until reindexed — matching the reference caveat.
"""

from __future__ import annotations

from typing import Iterable

SYNONYM_PREFIX = "~"


class SynonymMap:
    def __init__(self):
        self._groups: dict[str, list[str]] = {}      # group id -> terms
        self._by_term: dict[str, set[str]] = {}      # term -> group ids

    def update(self, group_id: str, terms: Iterable[str]) -> None:
        """FT.SYNUPDATE <group> term... — extends the group."""
        gid = str(group_id)
        existing = self._groups.setdefault(gid, [])
        for t in terms:
            t = t.lower()
            if t not in existing:
                existing.append(t)
            self._by_term.setdefault(t, set()).add(gid)

    def group_ids(self, term: str) -> set[str]:
        return self._by_term.get(term.lower(), set())

    def group_terms(self, term: str) -> list[str]:
        """Virtual index terms for a token (used by builder + expander)."""
        return [SYNONYM_PREFIX + g for g in sorted(self.group_ids(term))]

    def dump(self) -> dict[str, list[str]]:
        """FT.SYNDUMP: term -> group ids."""
        return {t: sorted(g) for t, g in self._by_term.items()}

    def __len__(self):
        return len(self._groups)
