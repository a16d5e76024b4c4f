# Copy of redisearch_tpu/agg/cursor.py: the port imports nothing of the JAX package.
"""Cursor registry (FT.AGGREGATE ... WITHCURSOR / FT.CURSOR READ|DEL).

Reference: src/cursor.c (CursorList, cursor.h:26-102) — parked requests
keyed by 64-bit ids with idle-timeout GC.  Here a cursor parks the computed
aggregation rows plus a read offset; chunked reads drain it.  (The engine
computes aggregations in one device pass, so "parked execution state" is
just the undelivered tail — the streaming behavior is identical from the
client's view.)
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

from ..utils.errors import CursorNotFound


@dataclasses.dataclass
class Cursor:
    cid: int
    index_name: str
    rows: list
    pos: int = 0
    count: int = 1000              # chunk size (READ COUNT override allowed)
    idle_timeout_s: float = 300.0  # reference default CURSOR_MAX_IDLE 300s
    last_access: float = dataclasses.field(default_factory=time.time)
    # streaming source: a chunk iterator pulled lazily on reads (the
    # RPNet analog — rows materialize only as the client drains them)
    source: Optional[object] = None

    def _pull(self, upto: int) -> None:
        """Fill the buffer from the source until `upto` rows are
        available past the read position (or the source drains)."""
        if self.source is None:
            return
        while len(self.rows) - self.pos < upto:
            try:
                self.rows.extend(next(self.source))
            except StopIteration:
                self.source = None
                break

    def exhausted(self) -> bool:
        return self.source is None and self.pos >= len(self.rows)


class CursorList:
    def __init__(self):
        self._cursors: dict[int, Cursor] = {}
        self._ids = itertools.count(1)

    def create(self, index_name: str, rows: list, count: int = 1000,
               idle_timeout_s: float = 300.0, source=None) -> Cursor:
        cid = next(self._ids)
        c = Cursor(cid=cid, index_name=index_name, rows=list(rows),
                   count=count, idle_timeout_s=idle_timeout_s,
                   source=source)
        self._cursors[cid] = c
        return c

    def read(self, cid: int, count: Optional[int] = None):
        """Returns (rows_chunk, cursor_id) — cursor_id 0 when exhausted,
        mirroring the reference reply."""
        self.collect_idle()
        c = self._cursors.get(cid)
        if c is None:
            raise CursorNotFound(f"Cursor not found, id: {cid}")
        c.last_access = time.time()
        n = count or c.count
        c._pull(n + 1)   # +1: learn whether more rows exist past n
        chunk = c.rows[c.pos:c.pos + n]
        c.pos += n
        if c.exhausted():
            del self._cursors[cid]
            return chunk, 0
        return chunk, cid

    def delete(self, cid: int) -> bool:
        return self._cursors.pop(cid, None) is not None

    def collect_idle(self) -> int:
        """GC idle cursors (reference: cursor idle timeout sweep)."""
        now = time.time()
        dead = [cid for cid, c in self._cursors.items()
                if now - c.last_access > c.idle_timeout_s]
        for cid in dead:
            del self._cursors[cid]
        return len(dead)

    def __len__(self):
        return len(self._cursors)
