"""The C. elegans cell (celegans_k27.fastq30x.x4): its sample's size and
cut as the configuration states them, and its two readers of the sharded
count's spans, feed_blocked_s and owner_skew_pct, on runs built from
synthetic records; they read nothing from a program without those spans,
as at a commit before them."""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import kmc_tpu_torch
from kmc_tpu_torch import trace
from kmcbench import spans
from kmcbench.harness import Job, Run, load_cell, load_reader

ROOT = Path(__file__).resolve().parents[2]
CELL = "celegans_k27.fastq30x.x4"
NEW = ("feed_blocked_s", "owner_skew_pct")


def test_sample_is_chromosomes_one_to_three_at_30x():
    cell = load_cell(CELL)
    s = cell.sample
    assert (s.n_reads, s.n_kmers(cell.knobs["kmer_len"])) == (
        8_827_131, 1_094_564_244)
    assert cell.chips == 4 and cell.traffic["name"] == "fastq30x"
    assert s.genome_bp == 15_072_434 + 15_279_421 + 13_783_801
    # the cut key names the published size beside the one run
    assert cell.config["reduced"] == ["genome_bp"]
    assert cell.config["published"]["genome_bp"] == 100_286_401
    assert "100,286,401" in cell.config["assumed"]["genome_bp"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == "celegans_k27"]
    assert entry["reduced"] == cell.config["reduced"]
    assert "WBcel235" in entry["source"] and len(entry["source"]) <= 200
    assert cell.knobs == load_cell("large_genome_k27.fastq30x").knobs
    assert {m["name"] for m in cell.per_layer} == {
        "exchange_s", "shard_ingest_s", "exchange_roofline_pct",
        "card_idle_pct", "feed_blocked_s", "owner_skew_pct",
        "shard_compact_s", "input_read_s"}


def _span(name, a, b, thread, parent=None, **counters):
    """A record: a and b in seconds of perf_counter."""
    return SimpleNamespace(name=name, start=int(a * 1e9), end=int(b * 1e9),
                           thread=thread, parent=parent, count=1,
                           counters=counters or None)


def _records(t, owner_rows, puts=((0.2, 0.25), (0.4, 0.43)), fed=True):
    """One sharded job's spans from t s: counting thread 1, feed thread 2;
    a kmc.feed_put for each of puts, a kmc.owner for each of owner_rows."""
    s1 = _span("kmc.stage1", t + 0.001, t + 0.8, 1)
    ingest = _span("kmc.ingest", t + 0.01, t + 0.79, 1, s1)
    feed = _span("kmc.ingest_feed", t + 0.011, t + 0.78, 2, ingest,
                 **(dict(batches=12, positions=12 << 22) if fed else {}))
    s2 = _span("kmc.stage2", t + 0.8, t + 0.99, 1)
    sort = _span("kmc.owner_sort", t + 0.85, t + 0.9, 1, s2)
    recs = [_span("kmc.feed_put", t + a, t + b, 2, feed) for a, b in puts]
    recs += [_span("kmc.owner", t + 0.85 + 0.01 * o, t + 0.86 + 0.01 * o, 1,
                   sort, rows=n, card=o)
             for o, n in enumerate(owner_rows)]
    return recs + [feed, ingest, s1, sort, s2]


def _run(n_jobs):
    jobs = [Job(i, 10.0 + i, 11.0 + i) for i in range(n_jobs)]
    return Run(cell=load_cell(CELL), device_kind="cpu", jobs=jobs,
               profiled=list(range(n_jobs)))


def test_readers_on_synthetic_records(monkeypatch):
    recs = (_records(10.0, [100, 100, 100, 100])
            + _records(11.0, [120, 100, 90, 90], puts=())
            + _records(12.0, [150, 100, 100, 50],
                       puts=((0.1, 0.4), (0.5, 0.6), (0.6, 0.7))))
    monkeypatch.setattr(trace, "records", lambda: recs)
    run = _run(3)
    # a job's blocked puts summed: 0.08, 0, 0.5 s; their median
    assert load_reader("feed_blocked_s").read(run) == pytest.approx(0.08)
    # the fullest owner over the mean, less 1: 0%, 20%, 50%; their median
    assert load_reader("owner_skew_pct").read(run) == pytest.approx(20.0)


def test_a_feed_that_never_blocked_reads_zero(monkeypatch):
    recs = _records(10.0, [1, 1], puts=())
    monkeypatch.setattr(trace, "records", lambda: recs)
    assert load_reader("feed_blocked_s").read(_run(1)) == 0.0


def test_a_program_without_the_new_counters_reads_nothing(monkeypatch):
    """As at the parent commit: the feed's span without its counters, and
    no owner spans."""
    recs = _records(10.0, [], puts=(), fed=False)
    monkeypatch.setattr(trace, "records", lambda: recs)
    for name in NEW:
        assert load_reader(name).read(_run(1)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(trace, "records", lambda: [])
    assert load_reader(name).read(_run(1)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(kmc_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "kmc_tpu_torch.trace", None)
    assert spans.records() is None
    assert load_reader(name).read(_run(1)) is None
