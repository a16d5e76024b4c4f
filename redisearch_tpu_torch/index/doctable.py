# Copy of redisearch_tpu/index/doctable.py: the port imports nothing of the JAX package.
"""Document table: key <-> id mapping + per-doc metadata + stored fields.

Reference: DocTable / RSDocumentMetadata (src/doc_table.c, src/redisearch.h:
97-132) plus — because this framework owns its own storage instead of
following a Redis keyspace — the document store itself (the reference's
equivalent is the Redis hash/JSON key the LOADER reads back).

Global doc ids are monotonically increasing u32s and are never reused
(matching the reference's incremental t_docId).  A sealed segment owns a
contiguous gid range, so gid -> (segment, local id) resolution is a binary
search over segment bases.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional


@dataclasses.dataclass
class DocMeta:
    """Per-document metadata (reference: RSDocumentMetadata)."""

    key: str
    gid: int
    score: float = 1.0
    payload: Optional[bytes] = None
    doclen: int = 0                 # total text tokens (BM25 length norm)
    max_freq: int = 0               # max term freq in doc (TFIDF norm)
    # doclen already folded into DocTable.total_doclen — tracked apart
    # from `doclen` so set_doclen stays correct no matter whether the
    # indexer mutated meta.doclen before or after calling it
    counted_doclen: int = 0
    deleted: bool = False
    # Doc-level TTL, absolute epoch seconds (reference: doc TTL on DMD).
    expires_at: Optional[float] = None
    # Field-level TTLs: field attribute -> absolute epoch seconds
    # (reference: TtlTable, src/redisearch_rs/ttl_table).
    field_expiration: Optional[dict[str, float]] = None
    # Per-doc language override (FT.ADD ... LANGUAGE, reference:
    # AddDocumentOptions.language, src/document_add.c:86); kept on the
    # metadata so reanalyze/compaction re-stems identically.
    language: Optional[str] = None
    # The stored document fields (this framework is its own keyspace).
    fields: dict[str, Any] = dataclasses.field(default_factory=dict)

    def is_expired(self, now: Optional[float] = None) -> bool:
        if self.expires_at is None:
            return False
        return (now if now is not None else time.time()) >= self.expires_at

    def field_expired(self, attr: str, now: Optional[float] = None) -> bool:
        if not self.field_expiration:
            return False
        ts = self.field_expiration.get(attr)
        if ts is None:
            return False
        return (now if now is not None else time.time()) >= ts


class DocTable:
    """key <-> gid map + metadata array (reference: src/doc_table.c)."""

    def __init__(self):
        self._by_key: dict[str, int] = {}
        self._metas: dict[int, DocMeta] = {}
        self._next_gid = 1  # doc ids start at 1, like the reference
        self.num_docs = 0
        self.total_doclen = 0

    # -- writes ----------------------------------------------------------
    def put(
        self,
        key: str,
        fields: dict[str, Any],
        score: float = 1.0,
        payload: Optional[bytes] = None,
    ) -> tuple[DocMeta, Optional[DocMeta]]:
        """Insert a document; returns (new meta, replaced meta or None)."""
        old = None
        old_gid = self._by_key.get(key)
        if old_gid is not None:
            old = self.delete(key)
        gid = self._next_gid
        self._next_gid += 1
        meta = DocMeta(key=key, gid=gid, score=score, payload=payload,
                       fields=fields)
        self._by_key[key] = gid
        self._metas[gid] = meta
        self.num_docs += 1
        return meta, old

    def delete(self, key: str) -> Optional[DocMeta]:
        gid = self._by_key.pop(key, None)
        if gid is None:
            return None
        meta = self._metas[gid]
        meta.deleted = True
        self.num_docs -= 1
        self.total_doclen -= meta.counted_doclen
        meta.counted_doclen = 0
        return meta

    def set_doclen(self, gid: int, doclen: int, max_freq: int) -> None:
        meta = self._metas[gid]
        self.total_doclen += doclen - meta.counted_doclen
        meta.counted_doclen = doclen
        meta.doclen = doclen
        meta.max_freq = max_freq

    # -- reads -----------------------------------------------------------
    def get_by_key(self, key: str) -> Optional[DocMeta]:
        gid = self._by_key.get(key)
        return self._metas.get(gid) if gid is not None else None

    def get(self, gid: int) -> Optional[DocMeta]:
        return self._metas.get(gid)

    def __contains__(self, key: str) -> bool:
        return key in self._by_key

    def __len__(self) -> int:
        return self.num_docs

    @property
    def avg_doclen(self) -> float:
        return self.total_doclen / self.num_docs if self.num_docs else 0.0

    @property
    def max_gid(self) -> int:
        return self._next_gid - 1
