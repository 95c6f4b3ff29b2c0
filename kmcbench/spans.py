"""The program's own spans (kmc_tpu_torch.trace) of a traced run, by
profiled job.

kmc_tpu_torch records a span of each step of a count while a
torch.profiler profile records: name, start and end on
time.perf_counter_ns (the clock of Job.start and Job.end), thread,
parent and counters.  A program without the tracer, or a run that
recorded none, gives no jobs, and the readers then return None.

A job's spans are those that start inside its interval; the counting
thread is the thread of its "kmc.stage1" span.  Program time maps onto
the device trace's clock by each job's offset, the mean of two: its
"job" window's start in the trace against its Job.start, and the
window's end against its Job.end.  The harness takes each pair one
after the other, but not at one instant: on an H100's host the start
alone mapped kmc.stage1 0.8-2.5 ms early and the end alone 1.5-2.1 ms
late against kmc.stage1's own annotation, their mean within 0.6 ms.
"""
from __future__ import annotations

import bisect


def records():
    """The program's recorded spans, or None where the program has no
    tracer or recorded nothing."""
    try:
        from kmc_tpu_torch import trace
    except ImportError:
        return None
    return trace.records() or None


class JobSpans:
    """The spans of one profiled job."""

    def __init__(self, job, spans, window=None):
        self.job = job
        self.spans = spans
        self.window = window  # (start, end) us of its "job" trace window
        self.stage1 = next(s for s in spans if s.name == "kmc.stage1")
        self.thread = self.stage1.thread

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float:
        return sum(s.end - s.start for s in self.named(name)) / 1e9

    def under_stage1(self, s) -> bool:
        while s is not None:
            if s is self.stage1:
                return True
            s = s.parent
        return False

    def innermost(self) -> list:
        """(start, end, name) ns of the counting thread's timeline, each
        piece named by its innermost open span."""
        own = sorted((s for s in self.spans if s.thread == self.thread),
                     key=lambda s: (s.start, -s.end))
        out, stack = [], []
        at = None
        for s in own + [None]:
            t = s.start if s is not None else float("inf")
            while stack and stack[-1].end <= t:
                top = stack.pop()
                if at < top.end:
                    out.append((at, top.end, top.name))
                at = top.end
            if s is None:
                break
            if stack and at < s.start:
                out.append((at, s.start, stack[-1].name))
            stack.append(s)
            at = s.start
        return out

    def to_trace_us(self, t_ns: float) -> float:
        """A perf_counter_ns time on the device trace's clock (us)."""
        offset = (self.window[0] - self.job.start * 1e6
                  + self.window[1] - self.job.end * 1e6) / 2
        return t_ns / 1e3 + offset


def profiled_jobs(run) -> list:
    """JobSpans of each profiled job that recorded its stage 1, in job
    order; with the device trace's job windows where run.trace has one
    for every profiled job."""
    recs = records()
    if recs is None or not run.profiled:
        return []
    jobs = [run.jobs[i] for i in run.profiled if i < len(run.jobs)]
    windows = None
    if run.trace is not None and len(run.trace.windows) == len(jobs):
        windows = sorted(run.trace.windows)
    out = []
    for n, job in enumerate(jobs):
        lo, hi = job.start * 1e9, job.end * 1e9
        spans = [s for s in recs if lo <= s.start <= hi]
        if any(s.name == "kmc.stage1" for s in spans):
            out.append(JobSpans(job, spans, windows and windows[n]))
    return out


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_us(busy, a: float, b: float) -> float:
    """The part of [a, b) that the merged, sorted busy intervals leave
    uncovered."""
    i = max(0, bisect.bisect_right(busy, [a, float("inf")]) - 1)
    covered = 0.0
    while i < len(busy) and busy[i][0] < b:
        lo, hi = max(busy[i][0], a), min(busy[i][1], b)
        if hi > lo:
            covered += hi - lo
        i += 1
    return (b - a) - covered


def device_busy(run) -> list:
    """The device trace's kernels, copies and sets, merged: sorted [start,
    end] us."""
    return _merged((a, b) for _, a, b in run.trace.device)
