"""Spans and counters of a count: where its time goes, on every thread.

    with trace.span("kmc.compact"):
        ...
        trace.add("rows", n)

A span times one step of the program.  It knows its thread and its
parent, the innermost span open on that thread when it opened; the first
span of a thread a count starts takes the span that started the thread
(span(name, parent=trace.current()) in the starting thread).  add(name,
n) adds n to a counter of the innermost span open on the calling thread.
Every span name starts with "kmc.".

Always on: a span adds its seconds, its call and its counters to the
totals of the count it belongs to (Count: one per Runner.run_stage1 /
run_stage2 pair, one per distributed_count), which the results read:
Stage1Results.time, Stage2Results' finalize split, Runner.spill_stats,
the sharded store's timings and the -v lines.  Off, a span costs a
global read, two clock reads and a dict add.

Recorded only while a torch.profiler profile records (torch's
torch.autograd.profiler._is_profiler_enabled, which reads true on every
thread of a profile_all_threads profile; read only once torch is
loaded): each span then opens a torch.profiler.record_function of its
name, which puts it in the profiler's trace on the device events' clock,
and is kept in memory until the next profile starts (seen as a start
once a span or a records() call saw the profiler off after the last);
records() returns them.  The annotation's op releases the interpreter
lock, so a traced span also holds the wait to take it back.

usage=True adds the thread's CPU seconds and minor page faults over the
span (RUSAGE_THREAD): user_s, sys_s and minflt.

This module loads no torch, so the readers and writers that use it run
without it.
"""
from __future__ import annotations

import itertools
import resource
import sys
import threading
import time
from collections import defaultdict

_local = threading.local()
_ids = itertools.count(1)
_switch = threading.Lock()
_records: list = []
_recording = False  # the last span opened saw the profiler on


class Count:
    """The totals of one count: seconds and calls by span name, counter
    sums by span name and counter."""

    def __init__(self):
        self.id = next(_ids)
        self._lock = threading.Lock()
        self._ns = defaultdict(int)
        self._calls = defaultdict(int)
        self._counters = defaultdict(int)  # (span name, counter) -> sum

    def _add(self, sp: "Span"):
        with self._lock:
            self._ns[sp.name] += sp.end - sp.start
            self._calls[sp.name] += 1
            if sp.counters:
                for key, n in sp.counters.items():
                    self._counters[sp.name, key] += n

    def seconds(self, *names: str) -> float:
        """Seconds in the spans of these names."""
        return sum(self._ns.get(n, 0) for n in names) / 1e9

    def calls(self, name: str) -> int:
        return self._calls.get(name, 0)

    def counter(self, key: str, *names: str):
        """The sum of counter key over the spans of these names (all spans
        when none are named)."""
        with self._lock:
            return sum(n for (span, k), n in self._counters.items()
                       if k == key and (not names or span in names))


class Span:
    """One timed step: name, start and end (time.perf_counter_ns), thread
    (threading.get_ident), parent (a Span or None), count (its Count's id,
    or None outside a count) and counters (a dict or None)."""

    __slots__ = ("name", "start", "end", "thread", "parent", "count",
                 "counters", "_totals", "_usage", "_rf")

    def __init__(self, name: str, parent, totals, usage: bool):
        self.name = name
        self.parent = parent
        self._totals = totals
        self._usage = usage
        self.counters = None
        self._rf = None
        self.start = self.end = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "Span":
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        if self._totals is None and self.parent is not None:
            self._totals = self.parent._totals
        self.count = None if self._totals is None else self._totals.id
        self.thread = threading.get_ident()
        stack.append(self)
        if self._usage:
            self._usage = resource.getrusage(resource.RUSAGE_THREAD)
        # the span holds its own annotation and the lock wait it costs
        self.start = time.perf_counter_ns()
        profiler = _profiler()
        if profiler is not None:
            self._rf = profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
            _records.append(self)
            _profiler()  # notes a profile that ended inside the span
        self.end = time.perf_counter_ns()
        if self._usage:
            u0, u1 = self._usage, resource.getrusage(resource.RUSAGE_THREAD)
            self.counters = self.counters or {}
            self.counters.update(user_s=u1.ru_utime - u0.ru_utime,
                                 sys_s=u1.ru_stime - u0.ru_stime,
                                 minflt=u1.ru_minflt - u0.ru_minflt)
        _stack().pop()
        if self._totals is not None:
            self._totals._add(self)
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _profiler():
    """torch.autograd.profiler while a profile records, else None.
    Notes each profile's start, which drops the records of the last
    profile seen to end: a span that opened or closed, or a
    records() call, saw the profiler off in between."""
    global _records, _recording
    if "torch" not in sys.modules:
        return None
    profiler = sys.modules.get("torch.autograd.profiler")
    on = profiler is not None and profiler._is_profiler_enabled
    if on != _recording:
        with _switch:
            if on and not _recording:
                _records = []
            _recording = on
    return profiler if on else None


def span(name: str, *, parent: Span | None = None, count: Count | None = None,
         usage: bool = False) -> Span:
    """A span to open with `with`.  parent: the span that started this
    thread, for a thread's first span; count: the totals of a count's
    outermost spans (the others take their parent's)."""
    return Span(name, parent, count, usage)


def add(name: str, n=1) -> None:
    """Add n to counter name of the innermost span open on this thread
    (nothing when none is open)."""
    stack = getattr(_local, "stack", None)
    if stack:
        sp = stack[-1]
        if sp.counters is None:
            sp.counters = {name: n}
        else:
            sp.counters[name] = sp.counters.get(name, 0) + n


def current() -> Span | None:
    """The innermost span open on this thread."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def current_count() -> Count | None:
    """The totals of the count the innermost open span belongs to."""
    sp = current()
    return None if sp is None else sp._totals


def records() -> list:
    """The spans the latest profile recorded, in the order they
    closed."""
    _profiler()
    return list(_records)
