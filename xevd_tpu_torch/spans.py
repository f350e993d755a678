"""The port's spans and counters: where the host's time goes, recorded by
the program itself, always on.

A span is a named interval on `time.perf_counter_ns()` (CLOCK_MONOTONIC
on Linux: the same clock in every process of a host, so the capture
workers' spans and the parent's line up, and the clock of the benchmark's
marks).  A span's parent is the span that encloses it on its own thread
(a per-thread stack): a span opened on a pool thread has none there.  A
counter, `add(name, n)`, adds to the record that is open.  Spans are per
GOP, per picture and per stage, never per CU: a few hundred a GOP job.

Spans and counters go to the innermost open `Record` of the process
(`record()`); with none open they are not kept.  `entry()` opens a record
that is numbered and kept among the last KEEP entry calls (`calls(n)`);
`take(rec)` copies a record made elsewhere -- a capture worker's, which
travels back with its capture -- into the open one, so that it belongs to
that entry call.

    with span("host.entropy"): ...       a block
    @span("host.parse")                   each call of a function
    run("host.derive", fn, *args)         one call, also from a pool thread
    add("stage.bytes", n)                 a counter

The recorder's cost, ns a span: `python tests/torch_span_cost.py`.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

KEEP = 16                    # entry calls kept by calls()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None       # index of the enclosing span in its record


class Record:
    """The spans (in the order they opened; None while one is still open)
    and counters ({name: n}) recorded while it was open; `call` is the
    entry call's number, None for a record that is not an entry call's."""
    __slots__ = ("call", "spans", "counts")

    def __init__(self, call=None, spans=None, counts=None):
        self.call = call
        self.spans = [] if spans is None else spans
        self.counts = {} if counts is None else counts


_lock = threading.Lock()
_open = []                                # the open records, innermost last
_calls = collections.deque(maxlen=KEEP)
_numbers = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    """This thread's open spans: (record, index, name, parent, start) each,
    or None for one opened with no record open."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """The span `name` around a `with` block, or around each call of the
    function it decorates."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        rec = _open[-1] if _open else None
        if rec is None:
            stack.append(None)
            return self
        top = stack[-1] if stack else None
        parent = top[1] if top is not None and top[0] is rec else None
        with _lock:
            i = len(rec.spans)
            rec.spans.append(None)
        stack.append((rec, i, self.name, parent, time.perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        top = _stack().pop()
        if top is not None:
            rec, i, name, parent, start = top
            rec.spans[i] = Span(name, start, end, parent)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


def run(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) inside the span `name`."""
    with span(name):
        return fn(*args, **kwargs)


def add(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the open record."""
    rec = _open[-1] if _open else None
    if rec is not None:
        with _lock:
            rec.counts[name] = rec.counts.get(name, 0) + n


@contextlib.contextmanager
def record(call=None):
    """Record this process's spans and counters into a new Record while
    the block runs (the innermost record takes them)."""
    rec = Record(call)
    _open.append(rec)
    try:
        yield rec
    finally:
        _open.remove(rec)


@contextlib.contextmanager
def entry():
    """An entry call's record: numbered, and kept among the last KEEP
    calls once it ends; as a decorator, one for each call."""
    with record(next(_numbers)) as rec:
        try:
            yield rec
        finally:
            _calls.append(rec)


def take(rec: Record) -> None:
    """Copy `rec`'s spans and counters into the open record (its spans'
    parents re-indexed there)."""
    into = _open[-1] if _open else None
    if into is None:
        return
    with _lock:
        base = len(into.spans)
        into.spans.extend(
            s if s is None or s.parent is None
            else s._replace(parent=s.parent + base) for s in rec.spans)
        for k, n in rec.counts.items():
            into.counts[k] = into.counts.get(k, 0) + n


def calls(n: int) -> list:
    """The Records of the last n entry calls that have ended, oldest
    first."""
    return list(_calls)[-n:] if n > 0 else []


def _covered(iv, a, b) -> int:
    """The length of [a, b] that the intervals iv cover."""
    total, end = 0, a
    for s, e in sorted(iv):
        s, e = max(s, end), min(e, b)
        if e > s:
            total += e - s
            end = e
    return total


def self_ns(spans, name: str) -> int:
    """The self time of the spans named `name`: each one's duration less
    the part of it that its children cover, summed."""
    kids = collections.defaultdict(list)
    for s in spans:
        if s is not None and s.parent is not None:
            kids[s.parent].append((s.start_ns, s.end_ns))
    return sum(s.end_ns - s.start_ns
               - _covered(kids[i], s.start_ns, s.end_ns)
               for i, s in enumerate(spans)
               if s is not None and s.name == name)


def self_ms(spans, name: str) -> float:
    return self_ns(spans, name) / 1e6


def total_ms(spans, name: str) -> float:
    """The durations of the spans named `name`, children included."""
    return sum(s.end_ns - s.start_ns for s in spans
               if s is not None and s.name == name) / 1e6


def self_ms_by_name(spans) -> dict:
    """{name: self ms} of every span name in `spans`, in first-seen
    order."""
    names = dict.fromkeys(s.name for s in spans if s is not None)
    return {k: round(self_ms(spans, k), 3) for k in names}
