"""The port's spans and counters, on the profiler's clock.

A span is a named interval of one piece of the program's work: its name,
its start and end (`now_ns`, the Unix clock in nanoseconds, the clock that
torch.profiler stamps its events on: an exported Chrome trace's event `ts`
in microseconds x 1000 plus the trace's `baseTimeNanoseconds`), the native
id of the thread that recorded it, its parent (the id of the span that
enclosed it on the same thread, or None) and its attributes (request ids,
a bucket, a count). Spans are kept in memory, the newest `CAPACITY` of
them, for whoever reads `spans()`; the profiler's own trace is the file
that operators already export.

When spans are recorded:
  * `span(name, **attrs)` and `record(name, t0_ns, t1_ns, **attrs)` record
    only while a torch.profiler session runs, whatever activities it
    records (torch.autograd.profiler._is_profiler_enabled, a flag of the
    whole process, so the engine's worker thread sees it too). Outside one
    a span costs that one check and stores nothing. While recording,
    `span` also opens a record_function range of its name, so a trace that
    records the host's ops places their launches under it;
  * `setup_span(name, **attrs)` always records: set-up's few spans a
    process (the kernel library, the model, the first calls).

`record` is for a span whose two ends fall on different threads (a
request, submitted on the caller's thread and answered on the worker's):
it has no parent and opens no range.

`count(name, site)` adds to a counter that is always on; `counts(name)`
reads it by site. The weight-copy counter ("weight_copies") is bumped
wherever the port makes a copy of a weight in another dtype or layout:
`site` says where.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 65536  # spans kept; the oldest go first

now_ns = time.time_ns

_store: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_counts: "collections.Counter" = collections.Counter()
_counts_lock = threading.Lock()


class Span:
    """One recorded interval; `t1` is None while it is open."""

    __slots__ = ("id", "name", "t0", "t1", "tid", "parent", "attrs")

    def __init__(self, name: str, t0: int, t1: Optional[int], parent, attrs):
        self.id = next(_ids)
        self.name, self.t0, self.t1 = name, t0, t1
        self.tid = threading.get_native_id()
        self.parent, self.attrs = parent, attrs

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{(self.t1 or self.t0) - self.t0} ns, {self.attrs})")


class span:
    """`with span(name, **attrs) as s:` records the block as a span while a
    profiler runs (`s` is the Span, whose `attrs` the block may add to),
    and does nothing else otherwise (`s` is None)."""

    __slots__ = ("name", "attrs", "_span", "_range")
    ALWAYS = False

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs
        self._span = None

    def __enter__(self) -> Optional[Span]:
        if not (self.ALWAYS or _profiler._is_profiler_enabled):
            return None
        stack = _stack()
        s = Span(self.name, now_ns(), None,
                 stack[-1].id if stack else None, self.attrs)
        stack.append(s)
        self._span = s
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        return s

    def __exit__(self, *exc) -> None:
        s = self._span
        if s is None:
            return
        if self._range is not None:
            self._range.__exit__(*exc)
        s.t1 = now_ns()
        stack = _stack()
        if stack and stack[-1] is s:
            stack.pop()
        _store.append(s)


class setup_span(span):
    """A span of set-up (the kernel library, the model, a first call),
    recorded whether or not a profiler runs."""

    __slots__ = ()
    ALWAYS = True


def record(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Record [t0_ns, t1_ns] as a span while a profiler runs (no parent, no
    range: its ends may lie on two threads)."""
    if _profiler._is_profiler_enabled:
        _store.append(Span(name, t0_ns, t1_ns, None, attrs))


def spans(name: Optional[str] = None) -> List[Span]:
    """The stored spans, oldest first (those named `name`, if given)."""
    out = list(_store)
    return out if name is None else [s for s in out if s.name == name]


def clear() -> None:
    """Forget every stored span and zero every counter."""
    _store.clear()
    with _counts_lock:
        _counts.clear()


def count(name: str, site: str) -> None:
    """Add one to counter `name` at `site`."""
    with _counts_lock:
        _counts[name, site] += 1


def counts(name: str) -> Dict[str, int]:
    """Counter `name` by site."""
    with _counts_lock:
        return {site: n for (k, site), n in _counts.items() if k == name}


def total(name: str) -> int:
    """Counter `name` over all its sites."""
    return sum(counts(name).values())


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack
