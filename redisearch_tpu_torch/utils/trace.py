"""Spans on the served search path, kept in memory.

`root(name)` opens the root span of a batch (one per
`SearchIndex.search_many` call) and `span(name)` a span inside it, each
a context manager; `count(name, n)` adds n to a counter of the open
batch.  They record only while a `torch.profiler` session records on the
calling thread (`torch.autograd._profiler_enabled()`), checked once when
the root opens and held for that batch: the program's window is the
device trace's by construction, and there is no switch of its own.  When
its batch does not record, a span costs one global check and returns a
shared no-op object, and a count costs one global check.

A record (`Record`) holds the span's name, its parent's name (None for a
root), the batch id every span of one root shares, its start and end on
`time.perf_counter_ns()`, and `child_ns`, the part of it that its child
spans cover: its self time is `end_ns - start_ns - child_ns`.  Records
go into one buffer of `MAX_RECORDS`, the oldest dropped first and
counted (`dropped()`).  Each thread keeps its own stack of open spans
(the RESP server serves batches from a pool of threads), so a span's
parent is of its own thread and batch.

A count (`Count`) goes into the same buffer: its name, the innermost
open span's name as its parent, its batch id and n.  It has no duration
and adds nothing to any span's child cover, so no span's self time
changes with it.  `records()` returns the spans and `counts()` the
counts, each oldest first.

No span opens a profiler range: the profiler marks a range that encloses
a launch or a copy as an annotation on the device's timeline, which a
reader of the trace would count as device work.  The one range the
tracer opens is the clock marker: at the first recorded root of a
profiler session it opens and closes `record_function(CLOCK_MARKER)`,
with nothing launched inside, and keeps its own `perf_counter_ns`
reading of that instant (`clock_ns()`, read inside the range).  A span
starts on the trace's timeline at `start_ns` plus (the marker's start in
the trace, in ns, less `clock_ns()`).  The profiler names no session, so
a session is told by a root that finds no profiler recording (or by
`clear()`): it readies the next session's marker.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

#: records the buffer holds; older ones are dropped first
MAX_RECORDS = 1 << 20
#: the one profiler range the tracer opens (host only, nothing inside)
CLOCK_MARKER = "rs.trace.clock"

Record = collections.namedtuple(
    "Record", "name parent batch start_ns end_ns child_ns")
Count = collections.namedtuple("Count", "name parent batch n")

_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_dropped = 0
_open = 0              # recording roots open, over all threads
_marked = False        # the current profiler session has its clock marker
_clock = None          # perf_counter_ns at the newest clock marker
_batch_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()   # .stack: this thread's open spans, or None


def _append(rec: tuple) -> None:
    global _dropped
    with _lock:
        if len(_records) == _records.maxlen:
            _dropped += 1
        _records.append(rec)


class _Noop:
    """The span of a batch that does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "parent", "batch", "stack", "start_ns", "child_ns")

    def __init__(self, name: str, parent, batch: int, stack: list):
        self.name, self.parent, self.batch = name, parent, batch
        self.stack = stack
        self.child_ns = 0

    def __enter__(self):
        self.stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = self.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += end - self.start_ns
        _append((self.name, self.parent, self.batch, self.start_ns, end,
                 self.child_ns))
        return False


class _Root(_Span):
    __slots__ = ()

    def __enter__(self):
        global _open, _marked, _clock
        with _lock:
            _open += 1
            mark, _marked = not _marked, True
        _local.stack = self.stack
        super().__enter__()
        if mark:
            with torch.profiler.record_function(CLOCK_MARKER):
                # read as the range's enter returns: the profiler's own
                # reading ends it (a first enter can take 100 us before)
                _clock = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _open
        super().__exit__(*exc)
        _local.stack = None
        with _lock:
            _open -= 1
        return False


def root(name: str):
    """The root span of a batch: records, with a new batch id, when a
    profiler session records; inside a recorded batch of this thread, a
    plain span of it."""
    global _marked
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        return _Span(name, top.name, top.batch, stack)
    if not torch.autograd._profiler_enabled():
        _marked = False     # the next session gets its own marker
        return _NOOP
    return _Root(name, None, next(_batch_ids), [])


def span(name: str):
    """A span inside the open batch of this thread (its parent the
    innermost open span); the shared no-op where the batch does not
    record."""
    if not _open:
        return _NOOP
    stack = getattr(_local, "stack", None)
    if not stack:
        return _NOOP
    top = stack[-1]
    return _Span(name, top.name, top.batch, stack)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` of the open batch of this thread,
    where that batch records."""
    if not _open:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        _append((name, top.name, top.batch, n))


def recording() -> bool:
    """Whether this thread is inside a recorded batch."""
    return bool(_open and getattr(_local, "stack", None))


def records() -> list:
    """The kept span records (`Record`), oldest first."""
    with _lock:
        kept = list(_records)
    return [Record._make(r) for r in kept if len(r) == len(Record._fields)]


def counts() -> list:
    """The kept counts (`Count`), oldest first."""
    with _lock:
        kept = list(_records)
    return [Count._make(r) for r in kept if len(r) == len(Count._fields)]


def dropped() -> int:
    """Records dropped for want of room since the last `clear`."""
    return _dropped


def clock_ns():
    """The `perf_counter_ns` reading at the newest clock marker, or None
    before the first."""
    return _clock


def self_ns(recs=None) -> dict:
    """Each name's self time in ns over `recs` (default: the kept
    records): its durations less the part its child spans cover."""
    out: dict = collections.defaultdict(int)
    for r in records() if recs is None else recs:
        out[r.name] += r.end_ns - r.start_ns - r.child_ns
    return dict(out)


def clear() -> None:
    """Drop every record and the clock reading; the next recorded root
    opens a clock marker."""
    global _dropped, _marked, _clock
    with _lock:
        _records.clear()
        _dropped, _marked, _clock = 0, False, None
