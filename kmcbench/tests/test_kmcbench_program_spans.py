"""The readers of the program's own spans (kmcbench/spans.py and six
metrics) on a run built from synthetic records, and their None where the
program records none or has no tracer, as at a commit before it."""
import sys
from types import SimpleNamespace

import pytest

import kmc_tpu_torch
from kmc_tpu_torch import trace
from kmcbench import devtrace, spans
from kmcbench.harness import Job, Run, load_cell, load_reader

NEW = ("parse_wait_s", "first_batch_s", "ingest_starved_s",
       "host_completer_s", "stage1_sys_cpu_s", "device_idle_parse_pct")
T0 = 5000.0  # us: the profiled job's window on the device trace's clock


def _span(name, a, b, thread, parent=None, **counters):
    """A record: a and b in seconds of perf_counter."""
    return SimpleNamespace(name=name, start=int(a * 1e9), end=int(b * 1e9),
                           thread=thread, parent=parent, count=1,
                           counters=counters or None)


def _records(t):
    """One job's spans from t s: counting thread 1, ingest worker 2,
    reader 3."""
    s1 = _span("kmc.stage1", t + 0.001, t + 0.8, 1, sys_s=0.2)
    worker = _span("kmc.ingest_worker", t + 0.003, t + 0.79, 2, s1,
                   sys_s=0.1)
    reader = _span("kmc.reader", t + 0.002, t + 0.5, 3, s1, sys_s=0.3)
    s2 = _span("kmc.stage2", t + 0.8, t + 0.99, 1, sys_s=0.5)
    route = _span("kmc.host_route", t + 0.85, t + 0.96, 1, s2)
    return [
        _span("kmc.read", t + 0.002, t + 0.1, 3, reader, sys_s=0.05),
        _span("kmc.parse_wait", t + 0.002, t + 0.302, 1, s1),
        _span("kmc.assemble", t + 0.302, t + 0.31, 1, s1),
        _span("kmc.queue_get", t + 0.003, t + 0.31, 2, worker),
        _span("kmc.ingest_launch", t + 0.32, t + 0.33, 2, worker),
        _span("kmc.ingest_launch", t + 0.4, t + 0.41, 2, worker),
        _span("kmc.queue_get", t + 0.33, t + 0.337, 2, worker),
        reader, worker, s1,
        _span("kmc.host_merge", t + 0.85, t + 0.9, 1, route),
        _span("kmc.host_completer", t + 0.9, t + 0.95, 1, route),
        route, s2,
    ]


def _run(with_trace=True):
    """Job 0 profiled (10 s to 11 s of perf_counter), job 1 not; the
    card busy from 0.1 s to 0.2 s into job 0."""
    jobs = [Job(0, 10.0, 11.0), Job(1, 11.0, 12.0)]
    tr = None
    if with_trace:
        tr = devtrace.Trace(windows=[(T0, T0 + 1e6)],
                            device=[("k", T0 + 1e5, T0 + 2e5)])
    return Run(cell=load_cell("large_genome_k27.fastq30x"),
               device_kind="cpu", jobs=jobs, trace=tr, profiled=[0])


@pytest.fixture
def recorded(monkeypatch):
    recs = _records(10.0) + _records(11.0)  # job 1's are not profiled
    monkeypatch.setattr(trace, "records", lambda: recs)
    return recs


def test_readers_on_synthetic_records(recorded):
    run = _run()
    got = {name: load_reader(name).read(run) for name in NEW}
    assert got["parse_wait_s"] == pytest.approx(0.3)
    assert got["first_batch_s"] == pytest.approx(0.319)
    assert got["ingest_starved_s"] == pytest.approx(0.307 + 0.007)
    assert got["host_completer_s"] == pytest.approx(0.05)
    # stage 1's and the started threads' outermost spans; not the read's
    # own counter, nor stage 2's
    assert got["stage1_sys_cpu_s"] == pytest.approx(0.6)
    # parse_wait from 0.002 s to 0.302 s less the card's 0.1 s of work,
    # over the 1 s window
    assert got["device_idle_parse_pct"] == pytest.approx(20.0, abs=1e-3)


def test_innermost_timeline_and_clock(recorded):
    (job,) = spans.profiled_jobs(_run())
    pieces = job.innermost()
    assert [p[2] for p in pieces] == [
        "kmc.stage1", "kmc.parse_wait", "kmc.assemble", "kmc.stage1",
        "kmc.stage2", "kmc.host_merge", "kmc.host_completer",
        "kmc.host_route", "kmc.stage2"]
    # the pieces tile the thread's spans, from stage 1's start to stage
    # 2's end
    assert all(p[1] == q[0] for p, q in zip(pieces, pieces[1:]))
    assert (pieces[0][0], pieces[-1][1]) == (job.stage1.start,
                                             job.named("kmc.stage2")[0].end)
    parse = pieces[1]
    assert (parse[1] - parse[0]) / 1e9 == pytest.approx(0.3)
    assert job.to_trace_us(10.5e9) == pytest.approx(T0 + 5e5)


def test_device_metric_needs_the_device_trace(recorded):
    assert load_reader("device_idle_parse_pct").read(_run(False)) is None
    assert load_reader("parse_wait_s").read(_run(False)) == \
        pytest.approx(0.3)


def test_no_host_route_reads_nothing(monkeypatch):
    recs = [r for r in _records(10.0) if r.name != "kmc.host_completer"]
    monkeypatch.setattr(trace, "records", lambda: recs)
    assert load_reader("host_completer_s").read(_run()) is None
    assert load_reader("parse_wait_s").read(_run()) == pytest.approx(0.3)


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(trace, "records", lambda: [])
    assert load_reader(name).read(_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_nothing(monkeypatch, name):
    """As at the parent commit: no kmc_tpu_torch.trace to import."""
    monkeypatch.delattr(kmc_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "kmc_tpu_torch.trace", None)
    assert spans.records() is None
    assert load_reader(name).read(_run()) is None
