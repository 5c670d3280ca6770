# Spans and counters of the port's offline requests, on the profiler's clock.
#
# TranscriberPipeline.run() opens `request(ident)`. While a request is current
# (in its thread, or in a thread that `joined` it), every `span` appends
# (name, start_ns, end_ns, parent span's name) to its record and every `count`
# adds to its counters. Times are time.perf_counter_ns(), the clock of
# time.perf_counter(). Each span also opens
# torch.profiler.record_function("svt_" + name), so under a profiler it sits on
# the kernels' timeline. With no request current a span records nothing but
# that range (and its own start and end).
#
# A span adds no device synchronisation and no readback: the spans around
# device work (decode_upload, decode_readback) time calls that block anyway.
# Finished requests are kept in memory, the newest RING of them; `finished()`
# returns them oldest first.

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time

import torch

RING = 4096  # finished requests kept
PREFIX = "svt_"  # of every profiler range the port opens

# (record, name of the innermost open span) of this thread or task.
_current = contextvars.ContextVar("svt_trace_current", default=None)
_ids = itertools.count(1)
_ring = collections.deque(maxlen=RING)
_lock = threading.Lock()  # the ring and the counters


class Record:
    """One request: its id, name (the file), spans [(name, start_ns, end_ns,
    parent's name or None)], counters {name: n}, start_ns and whether it
    raised."""

    __slots__ = ("id", "name", "spans", "counters", "start_ns", "failed")

    def __init__(self, ident, name):
        self.id, self.name = ident, name
        self.spans, self.counters = [], {}
        self.start_ns, self.failed = None, False


class span:
    """`with span(name) as s:` times the block (s.start, s.end in ns,
    s.seconds) and, inside a request, appends it to the request's record."""

    __slots__ = ("name", "start", "end", "_outer", "_token", "_range")

    def __init__(self, name):
        self.name = name
        self.start = self.end = None

    def __enter__(self):
        self._outer = outer = _current.get()
        if outer is not None:
            self._token = _current.set((outer[0], self.name))
        self.start = time.perf_counter_ns()
        self._range = profiler_range(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.end = time.perf_counter_ns()
        outer = self._outer
        if outer is not None:
            _current.reset(self._token)
            outer[0].spans.append((self.name, self.start, self.end, outer[1]))
        return False

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9


def profiler_range(name):
    """The profiler range "svt_" + name alone, kept in no request's record:
    for a span too frequent to keep per request (one per encoder layer)."""
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def request(ident):
    """Open the request span `request` of a new record (id from a process
    counter, name str(ident)) and make it this thread's current request.
    On exit the record joins the ring, flagged failed if the block raised."""
    rec = Record(next(_ids), str(ident))
    token = _current.set((rec, None))
    try:
        with span("request") as s:
            rec.start_ns = s.start
            yield rec
    except BaseException:
        rec.failed = True
        raise
    finally:
        _current.reset(token)
        with _lock:
            _ring.append(rec)


def current():
    """The current request's record, or None."""
    cur = _current.get()
    return None if cur is None else cur[0]


@contextlib.contextmanager
def joined(rec):
    """Make `rec` (a record from current()) this thread's current request: a
    background thread's spans then join the request that started it, under
    its `request` span."""
    token = _current.set((rec, "request"))
    try:
        yield
    finally:
        _current.reset(token)


def count(name, n):
    """Add n to the current request's counter `name`."""
    cur = _current.get()
    if cur is not None:
        counters = cur[0].counters
        with _lock:
            counters[name] = counters.get(name, 0) + n


def finished():
    """The finished requests' records, oldest first."""
    with _lock:
        return list(_ring)
