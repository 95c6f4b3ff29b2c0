"""shard_compact_s, the seconds a sharded job spends in its store-wide
compactions (the program's kmc.shard_compact spans), on runs built from
synthetic records: the median over the profiled jobs of each job's sum,
and nothing from a program without the span, as at a commit before it,
or from a cell of one card."""
from types import SimpleNamespace

import pytest

from kmc_tpu_torch import trace
from kmcbench.harness import Job, Run, load_cell, load_reader

NAME = "shard_compact_s"


def _span(name, a, b, thread, parent=None, **counters):
    """A record: a and b in seconds of perf_counter."""
    return SimpleNamespace(name=name, start=int(a * 1e9), end=int(b * 1e9),
                           thread=thread, parent=parent, count=1,
                           counters=counters or None)


def _sharded_job(t, passes):
    """One sharded job's spans from t s: a kmc.shard_compact of four shards
    for each (start, end) of passes, inside kmc.ingest, each over the
    shards' kmc.compact and kmc.compact_finish halves."""
    s1 = _span("kmc.stage1", t + 0.001, t + 0.8, 1)
    ingest = _span("kmc.ingest", t + 0.01, t + 0.79, 1, s1)
    recs = [s1, ingest, _span("kmc.stage2", t + 0.8, t + 0.99, 1)]
    for a, b in passes:
        sc = _span("kmc.shard_compact", t + a, t + b, 1, ingest, shards=4,
                   rows=1000)
        mid = a + (b - a) / 4
        recs += [sc, _span("kmc.compact", t + a, t + mid, 1, sc, rows=250),
                 _span("kmc.compact_finish", t + mid, t + b, 1, sc)]
    return recs


def _one_card_job(t):
    """A one-card job's spans: Runner's compactions, no store-wide pass."""
    s1 = _span("kmc.stage1", t + 0.001, t + 0.8, 1)
    return [s1, _span("kmc.compact", t + 0.1, t + 0.11, 1, s1, rows=9),
            _span("kmc.compact_finish", t + 0.11, t + 0.13, 1, s1),
            _span("kmc.stage2", t + 0.8, t + 0.99, 1)]


def _run(cell, n_jobs):
    jobs = [Job(i, 10.0 + i, 11.0 + i) for i in range(n_jobs)]
    return Run(cell=load_cell(cell), device_kind="cpu", jobs=jobs,
               profiled=list(range(n_jobs)))


def test_median_over_jobs_of_each_jobs_passes(monkeypatch):
    recs = (_sharded_job(10.0, [(0.1, 0.15), (0.3, 0.33)])
            + _sharded_job(11.0, [(0.2, 0.3)])
            + _sharded_job(12.0, [(0.1, 0.12), (0.3, 0.31), (0.5, 0.6)])
            + _sharded_job(13.0, []))
    monkeypatch.setattr(trace, "records", lambda: recs)
    # a job's passes summed: 0.08, 0.1, 0.13 and 0 s; their median
    got = load_reader(NAME).read(_run("celegans_k27.fastq30x.x4", 4))
    assert got == pytest.approx(0.09)


def test_a_program_without_the_span_reads_nothing(monkeypatch):
    """As at the parent commit: the shards' kmc.compact spans, no pass."""
    recs = [x for t in (10.0, 11.0)
            for x in _sharded_job(t, [(0.1, 0.2)])
            if x.name != "kmc.shard_compact"]
    monkeypatch.setattr(trace, "records", lambda: recs)
    assert load_reader(NAME).read(_run("celegans_k27.fastq30x.x4", 2)) is None


@pytest.mark.parametrize("cell", ["isolate_k27.fastq100x",
                                  "large_genome_k27.fastq30x"])
def test_a_cell_of_one_card_reads_nothing(monkeypatch, cell):
    recs = _one_card_job(10.0) + _one_card_job(11.0)
    monkeypatch.setattr(trace, "records", lambda: recs)
    assert load_reader(NAME).read(_run(cell, 2)) is None


def test_nothing_recorded_reads_nothing(monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: [])
    assert load_reader(NAME).read(_run("celegans_k27.fastq30x.x4", 1)) is None
