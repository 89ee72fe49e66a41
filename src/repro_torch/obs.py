"""In-process spans of the serving engines and the lowering.

A span is a named interval on ``time.perf_counter()`` (the clock the
engines' latency stamps use), with the index of the span that encloses it,
the request it serves (``rid``) and ``attrs``, which the body may fill
with counter deltas, never the counters themselves.  Spans go into one
process-wide ring of ``RING`` entries; the oldest fall out first and
``dropped()`` counts them.

Spans are step- and request-level only (a pure decode step records three),
never per layer, operator or lookup, so the recorder stays on.  It calls
no profiler: a profiler annotation would cost ~10× as much and leave
device-side copies in a trace.  Readers take ``spans()`` in process.  The
engines run on one thread, so one stack of open spans gives the parents.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

#: Spans the ring holds
RING = 1 << 16


class _Recorder:
    def __init__(self):
        self.ring: collections.deque[Span] = collections.deque(maxlen=RING)
        self.stack: list[int] = []
        self.begun = 0        # spans begun: the next index
        self.appended = 0     # spans that reached the ring

    def push(self, s: Span) -> None:
        self.ring.append(s)
        self.appended += 1


_REC = _Recorder()


class Span:
    """One interval: ``idx`` numbers spans in the order they begin,
    ``parent`` is the enclosing span's ``idx``.  As a context manager
    (``span``) it stamps ``t0`` on entry and ``t1`` on exit, also when the
    body raises, and then enters the ring."""

    __slots__ = ("name", "t0", "t1", "idx", "parent", "rid", "attrs")

    def __init__(self, name: str, rid: Optional[int],
                 t0: Optional[float] = None, t1: Optional[float] = None):
        self.name, self.rid, self.attrs = name, rid, {}
        self.t0, self.t1 = t0, t1
        self.idx, self.parent = None, None

    def __enter__(self) -> "Span":
        r = _REC
        self.idx = r.begun
        r.begun += 1
        self.parent = r.stack[-1] if r.stack else None
        r.stack.append(self.idx)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        r = _REC
        r.stack.pop()
        r.push(self)


def span(name: str, rid: Optional[int] = None) -> Span:
    """``with span(name) as s:`` records the body as span ``name``; the
    body may add to ``s.attrs``, and reads ``s.t1`` after it."""
    return Span(name, rid)


def record(name: str, t0: float, t1: float,
           rid: Optional[int] = None) -> Span:
    """Record a span stamped elsewhere (a request's queueing, which
    crosses steps); it has no parent."""
    r = _REC
    s = Span(name, rid, t0, t1)
    s.idx = r.begun
    r.begun += 1
    r.push(s)
    return s


def spans() -> list[Span]:
    """The spans in the ring, in the order they ended."""
    return list(_REC.ring)


def dropped() -> int:
    """How many spans the ring has pushed out."""
    return _REC.appended - len(_REC.ring)


def reset() -> None:
    """Empty the ring and the counts (tests)."""
    global _REC
    _REC = _Recorder()
