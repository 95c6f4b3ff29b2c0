"""The port's tracer (kmc_tpu_torch/trace.py): spans and counters of a
count, their totals behind the results' times, and the records a
torch.profiler profile keeps, with the span tree of a spilling count."""
import json
import re
import subprocess
import sys
import threading
import time
from contextlib import nullcontext
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).parent))
from util import random_reads, write_fastq  # noqa: E402

from kmc_tpu_torch import (EstimateHistogramCfg, Runner,  # noqa: E402
                           Stage1Params, Stage2Params,
                           distributed_count, make_mesh, trace)
from kmc_tpu_torch.io import readers  # noqa: E402
from kmc_tpu_torch.ops.store import DeviceKmerStore  # noqa: E402
from kmc_tpu_torch.parallel.multihost import _prefetch_groups  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
K, S = 27, 1 << 10
# genome length -> finalize route with a 4096-row store and 1024-position
# batches (tests/test_torch_spill.py): both spill
ROUTES = {"host": 20000, "replay": 3400}
SPILL_KEYS = {"n_spills", "spill_bytes", "t_spill_d2h", "n_remerges",
              "t_remerge", "t_host_merge", "merge_launches",
              "collect_launches", "finalize_route"}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    return {route: write_fastq(d / f"{route}.fastq",
                               random_reads(400, 100, seed=3, n_prob=0.003,
                                            genome_len=glen))
            for route, glen in ROUTES.items()}


def _count(fq, out, **kw):
    p1 = Stage1Params(input_files=[fq], kmer_len=K, batch_positions=S,
                      device_store_rows=4096, n_reader_threads=2)
    p2 = Stage2Params(output_file_name=str(out), cutoff_min=1)
    for key, val in kw.items():
        setattr(p1 if hasattr(p1, key) else p2, key, val)
    r = Runner(device="cpu")
    r1 = r.run_stage1(p1)
    r2 = r.run_stage2(p2)
    return r, r1, r2


def _profiler():
    try:
        from torch._C._profiler import _ExperimentalConfig

        return profile(activities=[ProfilerActivity.CPU],
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=[ProfilerActivity.CPU])


def _ancestors(sp):
    out = []
    while sp.parent is not None:
        sp = sp.parent
        out.append(sp)
    return out


def _seconds(recs, *names):
    return sum(r.end - r.start for r in recs if r.name in names) / 1e9


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_without_profiler_totals_fill_the_results(reads, tmp_path, route):
    before = trace.records()
    r, r1, r2 = _count(reads[route], tmp_path / "db")
    assert trace.records() == before  # nothing recorded
    st = r.spill_stats
    assert set(st) == SPILL_KEYS
    assert st["finalize_route"] == route and st["n_spills"] >= 2
    assert st["t_spill_d2h"] > 0 and st["spill_bytes"] > 0
    assert (st["t_host_merge"] > 0) == (route == "host")
    assert r1.time > 0 and r2.time > 0
    assert r1.time == r._count.seconds("kmc.stage1")
    assert r2.time == r._count.seconds("kmc.stage2")
    assert r.n_compactions >= st["n_spills"]
    assert r2.time_finalize_exec > 0
    if route == "host":  # the host route's merge and completer, no copy
        assert r2.time_finalize_exec == r._count.seconds("kmc.host_route")
        assert r2.time_finalize_d2h == 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_profiled_count_records_the_span_tree(reads, tmp_path, route):
    with _profiler() as prof:
        r, r1, r2 = _count(reads[route], tmp_path / "db")
    recs = trace.records()
    names = {x.name for x in recs}
    assert all(n.startswith("kmc.") for n in names)
    assert {"kmc.stage1", "kmc.stage2", "kmc.store_setup", "kmc.parse_wait",
            "kmc.parse", "kmc.assemble", "kmc.pack",
            "kmc.queue_put", "kmc.queue_get", "kmc.h2d",
            "kmc.ingest_launch", "kmc.compact", "kmc.spill",
            "kmc.spill_wait", "kmc.spill_d2h", "kmc.replay", "kmc.finalize",
            "kmc.write", "kmc.ingest_worker", "kmc.reader", "kmc.next_batch",
            "kmc.reader_start", "kmc.split", "kmc.ingest_drain"} <= names
    assert {x.count for x in recs} == {r._count.id}
    (stage1,) = [x for x in recs if x.name == "kmc.stage1"]
    (stage2,) = [x for x in recs if x.name == "kmc.stage2"]
    # the ingest worker's and the reader pool's spans, on threads of
    # their own, descend from the count's stage 1
    others = [x for x in recs if x.thread != stage1.thread]
    assert {x.name for x in others} >= {"kmc.ingest_worker", "kmc.reader",
                                        "kmc.queue_get", "kmc.parse",
                                        "kmc.spill"}
    assert all(stage1 in _ancestors(x) for x in others)
    for x in recs:
        if x.name in ("kmc.spill_wait", "kmc.spill_d2h"):
            assert x.parent.name == "kmc.spill"
        if x.name in ("kmc.host_merge", "kmc.host_completer"):
            assert x.parent.name == "kmc.host_route"
        if x.name == "kmc.ingest_worker":
            assert x.parent is stage1
        if x.name == "kmc.reader":  # started inside the first batch's wait
            assert x.parent.name == "kmc.next_batch"
            assert x.parent.parent is stage1
        if x.name in ("kmc.ingest_worker", "kmc.reader"):
            assert {"user_s", "sys_s", "minflt"} <= set(x.counters)
        if x.name == "kmc.parse":  # a chunk, read and parsed in one call
            assert x.parent.name == "kmc.reader"
            assert {"bytes", "read_s", "user_s", "sys_s",
                    "minflt"} <= set(x.counters)
    if route == "host":
        assert {"kmc.host_route", "kmc.host_merge",
                "kmc.host_completer"} <= names
        # the merge uploads the runs; the completer takes each merged key
        # range on the device and copies back only the records, the LUT
        # and the stats
        merges = [x.counters or {} for x in recs if x.name == "kmc.host_merge"]
        done = [x.counters or {} for x in recs
                if x.name == "kmc.host_completer"]
        assert sum(c.get("h2d_bytes", 0) for c in merges) > 0
        assert not any("d2h_bytes" in c for c in merges)
        assert sum(c.get("d2h_bytes", 0) for c in done) > 0
        assert sum(c.get("ranges", 0) for c in done) == 1
    # the results are the spans' totals
    assert r1.time == stage1.seconds and r2.time == stage2.seconds
    st = r.spill_stats
    assert st["t_spill_d2h"] == pytest.approx(
        _seconds(recs, "kmc.spill_wait", "kmc.spill_d2h"), abs=1e-9)
    assert st["t_host_merge"] == pytest.approx(
        _seconds(recs, "kmc.host_merge"), abs=1e-9)
    assert st["spill_bytes"] == sum(x.counters["bytes"] for x in recs
                                    if x.name == "kmc.spill_d2h")
    assert r.n_compactions == sum(x.name == "kmc.compact" for x in recs
                                  if stage1 in _ancestors(x))
    packs = [x for x in recs if x.name == "kmc.pack"]
    launches = [x for x in recs if x.name == "kmc.ingest_launch"]
    assert len(packs) == len(launches) == sum(
        (x.counters or {}).get("batches", 0) for x in recs
        if x.name == "kmc.assemble")
    assert sum(x.counters["positions"] for x in launches) == S * len(packs)
    # each span is a user annotation of the profiler's trace
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marked = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert names <= marked


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_count_records_its_feed_and_owners(reads, tmp_path, route):
    """distributed_count on four CPU shards: the feed thread counts the
    batches it packs and their positions, each owner's grouping sort
    counts the rows it received (all the rows exchanged), and the owner
    plan the fullest owner's planned rows."""
    D = 4
    with _profiler():
        res = distributed_count([reads[route]], str(tmp_path / "db"), k=K,
                                devices=make_mesh(D, device="cpu"),
                                cutoff_min=1, batch_positions=S,
                                capacity_rows_per_device=1 << 12)
    recs = trace.records()
    (stage1,) = [x for x in recs if x.name == "kmc.stage1"]
    (feed,) = [x for x in recs if x.name == "kmc.ingest_feed"]
    assert feed.thread != stage1.thread and stage1 in _ancestors(feed)
    launches = [x for x in recs if x.name == "kmc.ingest_launch"]
    assert feed.counters["batches"] == len(launches) > D
    assert feed.counters["positions"] == sum(
        x.counters["positions"] for x in launches) == S * len(launches)
    for x in recs:
        if x.name == "kmc.feed_put":
            assert x.parent is feed and x.thread == feed.thread
    owners = [x for x in recs if x.name == "kmc.owner"]
    assert len(owners) == D
    assert all(x.parent.name == "kmc.owner_sort" and x.counters["card"] == -1
               for x in owners)
    rows = [x.counters["rows"] for x in owners]
    n_cols = DeviceKmerStore(64, k=K, sig_len=9, both_strands=True,
                             n_bins=512, device="cpu").n_cols
    # every exchanged row is read once and written once: key columns and
    # its count, 4 bytes each
    assert res["exchange_bytes"] == 2 * 4 * (n_cols + 1) * sum(rows) > 0
    (plan,) = [x for x in recs if x.name == "kmc.owner_hist"]
    assert plan.counters["rows_max"] == max(rows)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_count_records_each_store_wide_compaction(reads, tmp_path,
                                                          D):
    """One kmc.shard_compact a store-wide compaction, on the counting
    thread inside kmc.ingest, counting its shards and their live rows;
    under it each shard's two halves, every shard's sort issued
    (kmc.compact) before any shard is finished (kmc.compact_finish)."""
    with _profiler():
        res = distributed_count([reads["replay"]], str(tmp_path / "db"), k=K,
                                devices=make_mesh(D, device="cpu"),
                                cutoff_min=1, batch_positions=S,
                                capacity_rows_per_device=1 << 12)
    recs = trace.records()
    passes = [x for x in recs if x.name == "kmc.shard_compact"]
    assert len(passes) == res["n_compactions"] > 0
    for sc in passes:
        assert sc.parent.name == "kmc.ingest" and sc.thread == sc.parent.thread
        assert sc.counters["shards"] == D
        halves = sorted((x for x in recs if x.parent is sc),
                        key=lambda x: x.start)
        assert [x.name for x in halves] == (["kmc.compact"] * D
                                            + ["kmc.compact_finish"] * D)
        assert sc.counters["rows"] == sum(x.counters["rows"]
                                          for x in halves[:D])
    assert sum(x.name == "kmc.compact" for x in recs) == D * len(passes)


def test_feed_waits_on_a_full_queue_inside_feed_put():
    """A consumer slower than the feed: the feed's puts that find the queue
    full wait inside kmc.feed_put, a child of kmc.ingest_feed on the feed
    thread; without a profile the count's totals still hold them."""
    groups = [["batch"] * 3 for _ in range(8)]
    count = trace.Count()
    for profiled in (False, True):
        with _profiler() if profiled else nullcontext():
            with trace.span("kmc.ingest", count=count) as root:
                for group in _prefetch_groups(iter(groups), s=5):
                    time.sleep(0.02)
    assert count.counter("batches", "kmc.ingest_feed") == 2 * 24
    assert count.counter("positions", "kmc.ingest_feed") == 2 * 120
    assert count.calls("kmc.feed_put") >= 2 and \
        count.seconds("kmc.feed_put") > 0
    recs = trace.records()
    (feed,) = [x for x in recs if x.name == "kmc.ingest_feed"]
    assert feed.parent is root and feed.thread != root.thread
    assert feed.counters == dict(feed.counters, batches=24, positions=120)
    puts = [x for x in recs if x.name == "kmc.feed_put"]
    assert puts and all(x.parent is feed and x.thread == feed.thread
                        for x in puts)


def test_serial_stream_waits_on_its_own_parse(reads, tmp_path):
    """One reader thread: the stream parses on the counting thread, inside
    kmc.parse_wait."""
    with _profiler():
        _count(reads["replay"], tmp_path / "db", n_reader_threads=1,
               n_threads=1)
    recs = trace.records()
    (stage1,) = [x for x in recs if x.name == "kmc.stage1"]
    waits = [x for x in recs if x.name == "kmc.parse_wait"]
    assert waits and all(x.thread == stage1.thread for x in waits)
    assert sum((x.counters or {}).get("bytes", 0) for x in waits) == Path(
        reads["replay"]).stat().st_size
    assert not any(x.name in ("kmc.read", "kmc.parse") for x in recs)


@pytest.mark.parametrize("estimate", [False, True])
@pytest.mark.parametrize("n_readers", [1, 2])
def test_readers_keep_one_read_buffer(tmp_path, monkeypatch, n_readers,
                                      estimate):
    """Each reader allocates one read buffer for the count, whatever the
    number of shards it ran (five files on two pool threads; the serial
    stream counts on kmc.parse_wait), and reads and parses each chunk in
    pieces; the pieces leave the database and the -e estimate as one
    piece a chunk writes them."""
    paths = [write_fastq(tmp_path / f"in{i}.fastq",
                         random_reads(300, 100, seed=40 + i, genome_len=3000))
             for i in range(5)]
    kw = dict(input_files=paths, n_reader_threads=n_readers)
    if estimate:
        kw["estimate_histogram_cfg"] = \
            EstimateHistogramCfg.ESTIMATE_AND_COUNT_KMERS
    _, whole, _ = _count(paths[0], tmp_path / "whole", **kw)
    monkeypatch.setattr(readers, "PIECE_BYTES", 4096)
    with _profiler():
        r, r1, _ = _count(paths[0], tmp_path / "pieces", **kw)
    recs = trace.records()
    pieces = sum(-(-Path(p).stat().st_size // 4096) for p in paths)
    if n_readers == 1:
        owners = [x for x in recs if x.name == "kmc.parse_wait"]
        assert not any(x.name == "kmc.reader" for x in recs)
    else:
        owners = [x for x in recs if x.name == "kmc.reader"]
        assert len(owners) == 2
        assert all(x.counters["buffers"] == 1 for x in owners)
    assert sum((x.counters or {}).get("buffers", 0) for x in owners) == \
        n_readers
    assert sum((x.counters or {}).get("pieces", 0) for x in owners) == \
        pieces > r._count.counter("chunks", "kmc.parse_wait") >= 5
    for suf in (".kmc_pre", ".kmc_suf"):
        assert Path(f"{tmp_path / 'whole'}{suf}").read_bytes() == \
            Path(f"{tmp_path / 'pieces'}{suf}").read_bytes()
    assert r1.estimated_histogram == whole.estimated_histogram
    assert bool(r1.estimated_histogram) == estimate


def test_new_profile_drops_the_last_records():
    with _profiler():
        with trace.span("kmc.first"):
            pass
    assert [x.name for x in trace.records()] == ["kmc.first"]
    with trace.span("kmc.unrecorded"):
        pass
    assert [x.name for x in trace.records()] == ["kmc.first"]
    with _profiler():
        with trace.span("kmc.second"):
            trace.add("n", 2)
            trace.add("n")
    (rec,) = trace.records()
    assert rec.name == "kmc.second" and rec.counters == {"n": 3}


def test_counters_and_parents():
    count = trace.Count()
    with trace.span("kmc.outer", count=count) as outer:
        trace.add("rows", 5)
        with trace.span("kmc.inner") as inner:
            trace.add("rows", 2)
        parent = trace.current()
        seen = []
        th = threading.Thread(target=lambda: seen.append(
            _in_thread(parent)))
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    assert trace.current() is None
    assert inner.parent is outer and outer.parent is None
    assert outer.counters == {"rows": 5} and inner.counters == {"rows": 2}
    (child,) = seen
    assert child.parent is outer and child.thread != outer.thread
    assert child.count == count.id
    assert count.calls("kmc.outer") == count.calls("kmc.inner") == 1
    assert count.counter("rows") == 7 + 1
    assert count.counter("rows", "kmc.inner") == 2
    assert count.seconds("kmc.outer") == outer.seconds > 0
    trace.add("rows", 1)  # no span open: nothing, no error


def _in_thread(parent):
    with trace.span("kmc.thread_root", parent=parent, usage=True) as sp:
        trace.add("rows", 1)
    assert {"user_s", "sys_s", "minflt"} <= set(sp.counters)
    return sp


def test_totals_from_many_threads_lose_nothing():
    """More threads than cores add to one count's totals at once."""
    count = trace.Count()
    n_threads, n_spans = 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with trace.span("kmc.root", count=count):
                for _ in range(n_spans):
                    with trace.span("kmc.step"):
                        trace.add("rows", 3)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert count.calls("kmc.step") == n_threads * n_spans
    assert count.counter("rows") == 3 * n_threads * n_spans


def test_span_names_are_the_programs_own():
    """Every span the port opens is named kmc.*, and none is one of the
    benchmark's own span names."""
    from kmcbench.harness import HOST_SPANS

    names = set()
    for path in (REPO / "kmc_tpu_torch").rglob("*.py"):
        names |= set(re.findall(r'trace\.span\(\s*"([^"]+)"',
                                path.read_text()))
    assert len(names) >= 30
    assert all(n.startswith("kmc.") for n in names), names
    assert not names & set(HOST_SPANS)


def test_tracer_and_readers_load_no_torch():
    code = ("import sys\n"
            "import kmc_tpu_torch.trace, kmc_tpu_torch.io.readers, "
            "kmc_tpu_torch.formats.kmc_db\n"
            "from kmc_tpu_torch import trace\n"
            "with trace.span('kmc.x'):\n"
            "    trace.add('n')\n"
            "assert trace.records() == []\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_profiler_flag_reads_true_on_worker_threads():
    """The switch the tracer reads: torch's Python-side flag, set for the
    whole process by a profile_all_threads profile."""
    seen = []
    with _profiler():
        th = threading.Thread(target=lambda: seen.append(
            torch.autograd.profiler._is_profiler_enabled))
        th.start()
        th.join(timeout=60)
    assert seen == [True]
    assert not torch.autograd.profiler._is_profiler_enabled
