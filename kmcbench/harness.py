"""Run one cell of the benchmark once: set-up, a window of count jobs
back to back, the check against the plain reference, and the result.

A job is what a user of a k-mer counter runs: a fresh
kmc_tpu_torch.Runner counts the sample's FASTQ (run_stage1, run_stage2,
as count() and the CLI do) into a new KMC2 database under the run's work
directory, the previous job's deleted once it ends.  A cell of several chips
counts it instead by one call of kmc_tpu_torch.distributed_count, one
process holding a shard of the store on each of its cards, into a new
database the same way.  The loop is closed: one job at a time, the next as soon as
the last ends; no job starts after the run's seconds, and the one running
then finishes and counts.  The window runs from the first job's start to
the last job's end.

Set-up (setup_s: from the process's start to the first job of the
window) imports torch and the port, writes the FASTQ, compressed where
the traffic mix says so (hot in the page cache from then on), and runs
one whole job, which builds the port's CUDA and native libraries on a
checkout's first run (kmc_tpu_torch/_build/) and loads them.

With trace on, the probes (probes.py) wrap the program for the window,
and torch.profiler covers its first whole jobs, up to TRACE_JOB_SECONDS
of them.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.profiler import record_function

from . import compare, compress, devtrace, reference
from .probes import STORE_SPANS, WRITER_SPANS, Probes
from .reads import Sample, write_fastq

ROOT = Path(__file__).resolve().parent.parent
TRACE_JOB_SECONDS = 3.0
# top-level module names the run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "kmc_tpu")
HOST_SPANS = (("job", "stage1", "stage2", "host_input")
              + tuple(STORE_SPANS.values()) + tuple(WRITER_SPANS.values()))


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)

    @property
    def knobs(self) -> dict:
        return self.config["knobs"]

    @property
    def sample(self) -> Sample:
        return Sample.of(self.config, self.traffic)

    @property
    def compression(self):
        """The traffic's input file's compression: None for plain FASTQ;
        a compression the harness cannot write stops the run."""
        kind = self.traffic.get("compression")
        if kind is not None:
            compress.check(kind)
        return kind


def _in_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", (cell,))


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named workload in root's BENCHMARK.json, with its
    configuration's file, its traffic mix's file and its metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (root / "kmcbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload)]
    return Cell(workload, config, traffic, int(w["chips"]), e2e, per_layer)


def load_reader(name: str, root: Path = ROOT):
    """The metric's reader, kmcbench/metrics/<name>.py: read(run) returns
    its value or None."""
    path = root / "kmcbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "kmcbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Job:
    index: int
    start: float
    end: float
    stats: dict = None         # stage 2's counts, as reference.stats names
    stage1_s: float = 0.0
    stage2_s: float = 0.0
    spill: dict = None         # Runner.spill_stats; sharded: the spill
    #                            counts, exchange_route and exchange_bytes
    timings: dict = None       # sharded: distributed_count's "timings"
    n_compactions: int = 0
    host_peak_bytes: int = 0
    host_start_bytes: int = 0  # resident set as the job starts
    device_peak_bytes: int = 0
    db_bytes: int = 0
    error: str = None

    @property
    def wall_s(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    device_kind: str
    jobs: list = field(default_factory=list)    # the window's jobs
    setup_s: float = 0.0
    window_s: float = 0.0
    probes: Probes = None
    trace: devtrace.Trace = None
    profiled: list = field(default_factory=list)  # indices of traced jobs

    @property
    def ok_jobs(self) -> list:
        return [j for j in self.jobs if j.error is None]


def process_age_s() -> float:
    """Seconds since this process started (/proc), the interpreter's
    start-up included."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def process_cpu_s() -> float:
    """User and system CPU seconds of every thread of this process."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _vm_hwm() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return 0


def _vm_rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class HostPeak:
    """The highest resident set of the process over a job: VmHWM after a
    reset (writing 5 to /proc/self/clear_refs); where the reset is
    refused, a thread reading the resident set every 5 ms."""

    def __init__(self):
        self._thread = None
        self._peak = 0

    def start(self):
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
        except OSError:
            self._peak = _vm_rss()
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()

    def _sample(self):
        while not self._stop.wait(0.005):
            self._peak = max(self._peak, _vm_rss())

    def stop(self) -> int:
        if self._thread is None:
            return _vm_hwm()
        self._stop.set()
        self._thread.join()
        self._thread = None
        return max(self._peak, _vm_rss())


def _params(knobs: dict, fastq: Path, out: Path, work: Path):
    from kmc_tpu_torch import Stage1Params, Stage2Params

    p1 = Stage1Params(input_files=[str(fastq)], tmp_path=str(work))
    p2 = Stage2Params(output_file_name=str(out))
    for key, value in knobs.items():
        hit = [p for p in (p1, p2) if hasattr(p, key)]
        if not hit:
            raise SystemExit(f"unknown knob {key!r} in the configuration")
        for p in hit:
            setattr(p, key, value)
    return p1, p2


def _db_path(work: Path, index: int) -> Path:
    """The database prefix of job index (the warm-up job's index is -1).
    Each job writes a new database, as the count of a new sample does, and
    the last job's is deleted once the next ends (_remove_db), so that no
    database lives long enough for the page cache to write it out: one
    written over the last would truncate it, which a file system such as
    ext4 answers by writing the new one out as it is closed."""
    return work / f"db{index + 1}"


def _remove_db(out: Path):
    for s in (".kmc_pre", ".kmc_suf"):
        Path(str(out) + s).unlink(missing_ok=True)


def _db_bytes(out: Path) -> int:
    """Bytes of the KMC2 database at prefix out."""
    return sum(Path(str(out) + s).stat().st_size
               for s in (".kmc_pre", ".kmc_suf")
               if Path(str(out) + s).exists())


def run_job(index: int, knobs: dict, fastq: Path, out: Path, work: Path,
            device: torch.device, probes: Probes = None) -> Job:
    """One count job; its errors are recorded, not raised."""
    from kmc_tpu_torch import Runner

    p1, p2 = _params(knobs, fastq, out, work)
    peak = HostPeak()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    start_rss = _vm_rss()
    peak.start()
    job = Job(index, time.perf_counter(), 0.0, host_start_bytes=start_rss)
    try:
        runner = Runner(device=str(device))
        if probes is None:
            r1 = runner.run_stage1(p1)
            r2 = runner.run_stage2(p2)
        else:
            with probes.span("stage1"):
                r1 = runner.run_stage1(p1)
            with probes.span("stage2"):
                r2 = runner.run_stage2(p2)
        if cuda:
            torch.cuda.synchronize(device)
        job.stats = dict(n_total=r2.n_total_kmers, n_unique=r2.n_unique_kmers,
                         n_below=r2.n_below_cutoff_min,
                         n_above=r2.n_above_cutoff_max)
        job.stage1_s, job.stage2_s = r1.time, r2.time
        job.spill = dict(runner.spill_stats)
        job.n_compactions = runner.n_compactions
        del runner
    except Exception as e:  # noqa: BLE001 - a failed job is a result
        job.error = f"{type(e).__name__}: {e}"
    job.end = time.perf_counter()
    job.host_peak_bytes = peak.stop()
    if cuda:
        job.device_peak_bytes = torch.cuda.max_memory_allocated(device)
    job.db_bytes = _db_bytes(out)
    return job


# a configuration's knob -> distributed_count's argument
SHARDED_KNOBS = {"kmer_len": "k", "canonical_kmers": "both_strands",
                 "cutoff_min": "cutoff_min", "cutoff_max": "cutoff_max",
                 "counter_max": "counter_max", "max_ram_gb": "max_ram_gb",
                 "batch_positions": "batch_positions",
                 "device_store_rows": "capacity_rows_per_device"}


def _sharded_args(knobs: dict) -> dict:
    """distributed_count's arguments from the configuration's knobs: the
    batch, the signature and the bins at the single-device runner's
    defaults (Stage1Params), and each shard's rows from the -m plan; a
    knob the sharded count cannot take stops the run."""
    from kmc_tpu_torch import Stage1Params

    d = Stage1Params()
    args = dict(batch_positions=d.batch_positions, sig_len=d.signature_len,
                n_bins=d.n_bins, capacity_rows_per_device=None)
    for key, value in knobs.items():
        if key not in SHARDED_KNOBS:
            raise SystemExit(f"knob {key!r} in the configuration: the "
                             "sharded count takes no such knob")
        args[SHARDED_KNOBS[key]] = value
    return args


def run_sharded_job(index: int, knobs: dict, fastq: Path, out: Path,
                    devices: list) -> Job:
    """One count job of a cell of several chips: one call of
    distributed_count with a shard on each of devices; its errors are
    recorded, not raised.  stage1_s is the count's ingest loop (its
    "ingest_wall_s" timing, 0 where the count returns no timings, as on
    the small-k route) and stage2_s the rest of the job's wall time."""
    from kmc_tpu_torch.parallel import multihost

    args = _sharded_args(knobs)
    cards = sorted({d for d in devices if d.type == "cuda"},
                   key=lambda d: d.index)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    peak = HostPeak()
    start_rss = _vm_rss()
    peak.start()
    job = Job(index, time.perf_counter(), 0.0, host_start_bytes=start_rss)
    try:
        res = multihost.distributed_count(
            [str(fastq)], str(out), devices=list(devices), **args)
        for d in cards:
            torch.cuda.synchronize(d)
        job.stats = {key: res[key] for key in
                     ("n_total", "n_unique", "n_below", "n_above")}
        job.timings = dict(res.get("timings", {}))
        job.n_compactions = res.get("n_compactions", 0)
        job.spill = {key: res.get(key, 0) for key in
                     ("n_spills", "n_remerges", "merge_launches",
                      "exchange_bytes")}
        job.spill["exchange_route"] = job.timings.get("exchange_route")
    except Exception as e:  # noqa: BLE001 - a failed job is a result
        job.error = f"{type(e).__name__}: {e}"
    job.end = time.perf_counter()
    if job.timings:
        job.stage1_s = job.timings.get("ingest_wall_s", 0.0)
        job.stage2_s = job.wall_s - job.stage1_s
    job.host_peak_bytes = peak.stop()
    job.device_peak_bytes = max(
        [torch.cuda.max_memory_allocated(d) for d in cards] + [0])
    job.db_bytes = _db_bytes(out)
    return job


def cell_devices(device: torch.device, chips: int) -> list:
    """The devices of a cell's shards: the first `chips` cards, or on the
    CPU (tests) `chips` shards of it."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [device] * chips


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"


def _work_base() -> Path:
    base = os.environ.get("TMPDIR")
    if base:
        return Path(base)
    path = ROOT / "_kmcbench_work"
    path.mkdir(exist_ok=True)
    return path


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda", log=None) -> dict:
    """Run cell once; returns the result line's object."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    t_setup0 = time.perf_counter()
    age0 = process_age_s()
    work = Path(tempfile.mkdtemp(prefix="kmcbench-", dir=_work_base()))
    try:
        return _run(cell, seed, seconds, traced, device, work, log,
                    t_setup0, age0)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, work, log, t_setup0, age0):
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    knobs, sample = cell.knobs, cell.sample
    compression = cell.compression
    # the port takes its gzip routes by the suffix
    fastq = work / ("reads.fastq" if compression is None
                    else "reads.fastq.gz")
    # the resident set at each step of set-up: what a job starts from
    log(f"resident set before the input: {_vm_rss()} bytes")
    n_fastq = write_fastq(fastq, sample, seed, device, compression, log)
    log(f"input: {sample.n_reads} reads of {sample.read_len} bp, "
        f"{sample.n_kmers(knobs['kmer_len'])} k-mers, {n_fastq} bytes of "
        f"FASTQ ({time.perf_counter() - t_setup0:.3f} s); resident set "
        f"{_vm_rss()} bytes")
    written = fastq.stat().st_size  # bytes of the files the run wrote
    if cell.chips == 1:
        devices = [device]

        def job_run(i, probes=None):
            return run_job(i, knobs, fastq, _db_path(work, i), work, device,
                           probes)
    else:
        devices = cell_devices(device, cell.chips)

        def job_run(i, probes=None):
            return run_sharded_job(i, knobs, fastq, _db_path(work, i),
                                   devices)
    warm = job_run(-1)
    written += warm.db_bytes
    log(f"warm-up job: {warm.wall_s:.4f} s, host peak "
        f"{warm.host_peak_bytes} bytes (at its start "
        f"{warm.host_start_bytes}), resident set after it {_vm_rss()} bytes"
        + (f", failed: {warm.error}" if warm.error else ""))
    run = Run(cell=cell, device_kind=kind)
    readers = {m["name"]: load_reader(m["name"])
               for m in (cell.per_layer if traced else cell.end_to_end)}
    prof = prof_done = None
    if traced:
        warm_prof = devtrace.profiler(device.type)  # its own start-up
        warm_prof.start()
        for d in devices:
            torch.ones(1, device=d).add_(1)
            if cuda:
                torch.cuda.synchronize(d)
        warm_prof.stop()
        run.probes = Probes()
        run.probes.install()
        prof = devtrace.profiler(device.type)
    t0 = time.perf_counter()
    run.setup_s = age0 + (t0 - t_setup0)
    cpu0 = process_cpu_s()
    profiled_s = 0.0
    try:
        if prof is not None:
            prof.start()
        while True:
            i = len(run.jobs)
            if i and time.perf_counter() - t0 >= seconds:
                break
            if run.probes is not None:
                run.probes.job = i
            label = record_function("job") if prof is not None else None
            with label or nullcontext():
                job = job_run(i, run.probes)
            if prof is not None:
                run.profiled.append(i)
                profiled_s += job.wall_s
                if profiled_s >= TRACE_JOB_SECONDS:
                    prof.stop()
                    prof_done, prof = prof, None
            run.jobs.append(job)
            _remove_db(_db_path(work, i - 1))
            written += job.db_bytes
            if job.error:
                break
        if prof is not None:
            prof.stop()
            prof_done = prof
    finally:
        if run.probes is not None:
            run.probes.remove()
    cpu_s = process_cpu_s() - cpu0  # the host's slow spells raise it
    last = run.jobs[-1]
    run.window_s = last.end - run.jobs[0].start
    bad = forbidden_modules()
    if bad:
        raise SystemExit("loaded modules of JAX or the JAX package: "
                         + ", ".join(bad))
    if cuda:
        log(f"card: {card_line()}")
    log(f"set-up: {run.setup_s:.4f} s")
    mem_peak = max([j.device_peak_bytes for j in run.jobs]
                   + [warm.device_peak_bytes])
    for j in run.jobs:
        log(f"job {j.index}: at {j.start - run.jobs[0].start:.3f} s of the "
            f"window, {j.wall_s:.4f} s, stage1 {j.stage1_s:.4f} s, "
            f"stage2 {j.stage2_s:.4f} s, device peak {j.device_peak_bytes} "
            f"bytes, host peak {j.host_peak_bytes} bytes (at its start "
            f"{j.host_start_bytes}), "
            f"{j.n_compactions} compactions, spill {j.spill}"
            + (f", timings {j.timings}" if j.timings else "")
            + (f", failed: {j.error}" if j.error else ""))
    log(f"jobs: {len(run.jobs)} in a window of {run.window_s:.4f} s, "
        f"{cpu_s:.3f} s of the process's CPU; bytes "
        f"written: {written}; device peak of a job: {mem_peak} bytes")
    if prof_done is not None:
        run.trace = devtrace.read(prof_done, work / "trace.json", HOST_SPANS)
        del prof_done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference.count(sample, seed, knobs["kmer_len"], device)
    kept = ref.kept(knobs["cutoff_min"], knobs["cutoff_max"],
                    knobs["counter_max"])[0].numel()
    log(f"reference: {ref.keys.numel()} distinct k-mers, {kept} kept, "
        f"{int((ref.counts > knobs['counter_max']).sum())} counted past "
        "counter_max")
    numbers = compare.judge_db(_db_path(work, last.index), ref, knobs,
                               [warm.stats] + [j.stats for j in run.jobs],
                               device)
    del ref
    log(f"check against the reference: {time.perf_counter() - t_check:.3f}"
        " s" + (f" ({numbers['unreadable']})" if "unreadable" in numbers
                else ""))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(j.error is not None for j in run.jobs)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": mem_peak}
    result = {"correct": (not failed and warm.error is None
                          and compare.passed(numbers)),
              "attempted": len(run.jobs), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        # several cards: the mean card's busy seconds
        dev["busy_s"] = (run.trace.busy_s if cell.chips == 1 else
                         sum(run.trace.card_busy_s(cell.chips)) / cell.chips)
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = compare.checks(numbers)
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return result
