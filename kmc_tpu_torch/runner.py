"""Orchestrator: the two-stage counting pipeline and its public API.

The port's counterpart of kmc_tpu/runner.py, with the same parameters,
results and fluent setters (KMC's kmc_runner.h:100-255), for the default
`kmc` run:

  stage 1  parse -> BatchStream -> pack_codes_boundaries -> device store
           ingest (splitter-scan kernel), compacting (grouping-sort kernel)
           whenever the store fills and spilling the compacted store to
           host RAM (under the -m budget) when compaction frees too little;
  stage 2  finalize_records (spill replay, or the runs merged on the device
           and the host completer; grouping sort + completer) ->
           Kmc2DbWriter.

Stage-1 state checkpoints to .npz files in kmc_tpu's format
(save_stage1_checkpoint / resume_stage1_checkpoint), so a checkpoint
written by either package resumes in the other.

Every option outside that path raises NotImplementedError naming the
ROADMAP item that ports it; nothing falls back silently.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Optional

import numpy as np

from . import defs
from .defs import calc_counter_size
from .device import device_name, resolve_device
from .formats.kmc_db import DbInfo, Kmc2DbWriter, pick_lut_prefix_len
from .io.native import pack_codes_boundaries, pack_codes_fused
from .io.readers import (
    BatchStream,
    ParseState,
    file_code_stream,
    homopolymer_compress_stream,
    parallel_code_stream,
    set_chunk_bytes,
)
from .memory import plan_memory

MIN_DEVICE_K = 14  # k <= 13 is kmc_tpu's small-k path (KMC1 output)


class InputFileType(Enum):
    FASTQ = "fastq"
    FASTA = "fasta"
    MULTILINE_FASTA = "multifasta"
    BAM = "bam"
    KMC = "kmc"


class OutputFileType(Enum):
    KMC = "kmc"
    KFF = "kff"


class EstimateHistogramCfg(Enum):
    DONT_ESTIMATE = 0
    ESTIMATE_AND_COUNT_KMERS = 1
    ONLY_ESTIMATE = 2


def _fluent(cls):
    """Add KMC-style SetX fluent setters for every dataclass field."""
    for name in cls.__dataclass_fields__:
        setter_name = "Set" + "".join(w.capitalize() for w in name.split("_"))

        def make(n):
            def setter(self, value):
                setattr(self, n, value)
                return self

            return setter

        setattr(cls, setter_name, make(name))
    return cls


@_fluent
@dataclass
class Stage1Params:
    input_files: list = field(default_factory=list)
    tmp_path: str = "."
    kmer_len: int = defs.DEFAULT_K
    n_threads: int = 0
    # -sf: parser/reader thread count; 0 = derive from n_threads
    n_reader_threads: int = 0
    max_ram_gb: int = 12
    signature_len: int = defs.DEFAULT_SIGNATURE_LEN
    homopolymer_compressed: bool = False
    input_file_type: InputFileType = InputFileType.FASTQ
    canonical_kmers: bool = True
    ram_only_mode: bool = False
    n_bins: int = defs.DEFAULT_N_BINS
    estimate_histogram_cfg: EstimateHistogramCfg = EstimateHistogramCfg.DONT_ESTIMATE
    strict_memory_mode: bool = False
    verbose: bool = False
    # candidate k-mer positions per device batch
    batch_positions: int = 1 << 22
    # keep the k-mer store on the device (False is kmc_tpu's host-bucket
    # path); None rows = derive them from max_ram_gb (memory.plan_memory)
    device_store: bool = True
    device_store_rows: int | None = None
    signature_map_policy: str = "prefix"
    logger: object = None
    percent_progress_observer: object = None
    progress_observer: object = None

    def validate(self):
        if not (defs.MIN_K <= self.kmer_len <= defs.MAX_K):
            raise ValueError(f"k must be in [{defs.MIN_K},{defs.MAX_K}]")
        if not (defs.MIN_SL <= self.signature_len <= defs.MAX_SL):
            raise ValueError(f"signature length must be in [{defs.MIN_SL},{defs.MAX_SL}]")
        if not (defs.MIN_N_BINS <= self.n_bins <= defs.MAX_N_BINS):
            raise ValueError(f"n_bins must be in [{defs.MIN_N_BINS},{defs.MAX_N_BINS}]")
        if not self.input_files:
            raise ValueError("no input files")

    def check_ported(self):
        """Raise NotImplementedError for options this package does not
        count yet."""
        if self.kmer_len < MIN_DEVICE_K:
            raise NotImplementedError(
                f"k={self.kmer_len}: k <= 13 (small-k path, KMC1 output) is "
                "ROADMAP A9")
        if self.signature_map_policy != "prefix":
            raise NotImplementedError(
                f"signature_map_policy={self.signature_map_policy!r}: the "
                "greedy policy is ROADMAP A7")
        if not self.device_store:
            raise NotImplementedError(
                "device_store=False (host buckets) is ROADMAP A9")
        if self.estimate_histogram_cfg != EstimateHistogramCfg.DONT_ESTIMATE:
            raise NotImplementedError(
                "-e / --opt-out-size (histogram estimation) is ROADMAP A12")
        if self.input_file_type in (InputFileType.BAM, InputFileType.KMC):
            raise NotImplementedError(
                f"input format {self.input_file_type.value!r} is ROADMAP A10")


@_fluent
@dataclass
class Stage2Params:
    max_ram_gb: int = 12
    n_threads: int = 0
    strict_memory_mode: bool = False
    cutoff_min: int = defs.DEFAULT_CUTOFF_MIN
    counter_max: int = defs.DEFAULT_COUNTER_MAX
    cutoff_max: int = defs.DEFAULT_CUTOFF_MAX
    output_file_name: str = ""
    output_file_type: OutputFileType = OutputFileType.KMC
    without_output: bool = False

    def validate(self):
        if self.cutoff_min < 1:
            raise ValueError("cutoff_min must be >= 1")
        if self.counter_max < 1:
            raise ValueError("counter_max must be >= 1")

    def check_ported(self):
        """Raise NotImplementedError for options this package does not
        write yet."""
        if self.without_output or self.output_file_type != OutputFileType.KMC:
            raise NotImplementedError(
                "KFF output and -w (without output) need the words-path "
                "finalize, ROADMAP A6")


@dataclass
class Stage1Results:
    time: float = 0.0
    n_sequences: int = 0
    was_small_k_opt_used: bool = False
    n_total_super_kmers: int = 0
    tmp_size: int = 0
    estimated_histogram: list = field(default_factory=list)


@dataclass
class Stage2Results:
    time: float = 0.0
    time_strict_mem: float = 0.0
    # finalize split: device execution vs the device-to-host copy
    time_finalize_exec: float = 0.0
    time_finalize_d2h: float = 0.0
    tmp_size_strict_memory: int = 0
    max_disk_usage: int = 0
    n_below_cutoff_min: int = 0
    n_above_cutoff_max: int = 0
    n_total_kmers: int = 0
    n_unique_kmers: int = 0


def n_cpus() -> int:
    try:  # respect cgroup/affinity limits, not the physical count
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


class Runner:
    """Two-stage k-mer counter on one device (KMC's kmc_runner.h:246-255).

    device: "cuda" (default) or "cpu"; "cuda" without a card raises."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._s1: Optional[Stage1Params] = None
        self._store = None
        self._sig_map = None
        self._n_used_bins = 0
        self._n_reads = 0
        self.n_compactions = 0  # store compactions in the last stage 1
        # spills, re-merges and the finalize route of the last count, with
        # their bytes and times (set by stage 1, completed by stage 2)
        self.spill_stats: dict = {}

    # ---------------- stage 1 ----------------
    def run_stage1(self, params: Stage1Params) -> Stage1Results:
        params.validate()
        params.check_ported()
        self._s1 = params
        t0 = time.perf_counter()
        results = Stage1Results()
        self._run_stage1_device_store(params, results)
        results.n_sequences = self._n_reads
        results.time = time.perf_counter() - t0
        return results

    def _memory_plan(self, params: Stage1Params):
        """The -m carve for this run; also sizes the parse chunks."""
        plan = plan_memory(
            params.max_ram_gb, k=params.kmer_len,
            batch_positions=params.batch_positions,
            n_threads=params.n_threads or n_cpus(),
            strict_memory=params.strict_memory_mode,
            requested_rows=params.device_store_rows)
        set_chunk_bytes(plan.parse_chunk_bytes)
        return plan

    def _chunks(self, params: Stage1Params):
        state = ParseState()
        fmt = params.input_file_type.value
        # -sf bounds the reader pool independently of -t
        n_th = params.n_reader_threads or params.n_threads or n_cpus()
        if n_th > 1:
            # N parser threads over record-aligned shards; the chunk stream
            # is a boundary refinement of the serial one
            source = parallel_code_stream(params.input_files, fmt, state,
                                          n_threads=n_th)
        else:
            source = file_code_stream(params.input_files, fmt, state)
        if params.homopolymer_compressed:
            source = homopolymer_compress_stream(source)
        for chunk in source:
            yield chunk, state
        self._n_reads = state.n_reads

    def _run_stage1_device_store(self, params: Stage1Params,
                                 results: Stage1Results):
        """Parse on the host, count on the device (mirrors kmc_tpu's
        _run_stage1_device_store for the prefix policy)."""
        from .ops.store import DeviceKmerStore

        k, m = params.kmer_len, params.signature_len
        s = params.batch_positions
        bs = BatchStream(s, k)
        plan = self._memory_plan(params)
        capacity = max(plan.device_store_rows, 2 * s)
        # the card holds the whole store from the start; on the CPU (tests)
        # it starts small and grows
        init_rows = capacity if self.device.type == "cuda" else 2 * s
        store = DeviceKmerStore(
            capacity, k=k, sig_len=m, both_strands=params.canonical_kmers,
            n_bins=params.n_bins, initial_rows=init_rows,
            spill_budget_bytes=plan.spill_budget_bytes, device=self.device)
        total_bytes = sum(
            Path(p).stat().st_size for p in params.input_files if Path(p).exists()
        )
        ppo = params.percent_progress_observer
        if ppo is not None:
            ppo.set_label("Stage 1: ")
        state_ref = None
        t_host = t_queue = 0.0
        t_prev = time.perf_counter()
        chunk_gen = self._chunks(params)

        def gen():
            nonlocal state_ref
            for c, st in chunk_gen:
                state_ref = st
                yield c

        # producer/consumer split: this thread parses and packs (native C,
        # GIL released) while a worker thread copies each batch to the
        # device and runs the ingest (and the compactions and spills it
        # triggers; their errors reach this thread through `errors`)
        q: queue.Queue = queue.Queue(maxsize=3)
        errors: list = []

        def worker():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    if item[0] == "b":
                        store.ingest_boundaries(item[1], item[2], s=s)
                    else:
                        store.ingest_fused(item[1], s=s)
            except BaseException as e:  # noqa: BLE001 - re-raised after join
                errors.append(e)
                while q.get() is not None:  # unblock the producer
                    pass

        th = threading.Thread(target=worker, name="kmc-ingest", daemon=True)
        th.start()
        try:
            for batch in bs.batches(gen()):
                # boundary-delta feed when sentinels are sparse; packed+mask
                # for sentinel-dense batches
                buf, ts = pack_codes_boundaries(batch)
                item = ("b", buf, ts) if buf is not None else (
                    "m", pack_codes_fused(batch))
                t_now = time.perf_counter()
                t_host += t_now - t_prev
                if errors:
                    break
                q.put(item)
                if ppo is not None and total_bytes and state_ref is not None:
                    ppo.set_progress(
                        min(99, state_ref.consumed_bytes * 100 // total_bytes)
                    )
                t_prev = time.perf_counter()
                t_queue += t_prev - t_now
        finally:
            # always deliver the sentinel, so a parse error cannot leave the
            # worker blocked on the queue
            q.put(None)
            th.join()
        if errors:
            raise errors[0]
        if ppo is not None:
            ppo.set_progress(100)
        if params.verbose:
            print(f"[stage1] on {device_name(self.device)}: "
                  f"host(parse+pack): {t_host:.2f}s "
                  f"queue-wait: {t_queue:.2f}s "
                  f"({store.total_appended_rows // max(s, 1)} batches, "
                  f"{store.n_compactions} compactions, {store.n_spills} "
                  f"spills of {store.spill_bytes} bytes, spill D2H "
                  f"{store.t_spill_d2h:.2f}s, {store.n_remerges} re-merges "
                  f"{store.t_remerge:.2f}s)")
        self._store = store
        self.n_compactions = store.n_compactions
        self.spill_stats = self._spill_stats(store)
        self._sig_map = store.host_sig_map()
        self._n_used_bins = store.n_used_bins
        results.n_total_super_kmers = store.total_super_kmers()

    @staticmethod
    def _spill_stats(store) -> dict:
        return dict(n_spills=store.n_spills, spill_bytes=store.spill_bytes,
                    t_spill_d2h=store.t_spill_d2h,
                    n_remerges=store.n_remerges, t_remerge=store.t_remerge,
                    t_host_merge=store.t_host_merge,
                    merge_launches=store.merge_launches,
                    finalize_route=store.finalize_route)

    # ---------------- checkpoint / resume ----------------
    # Stage-1 output is the natural checkpoint: the store, its spilled runs
    # and a .meta sidecar, in kmc_tpu's files (kmc_tpu/runner.py).
    def save_stage1_checkpoint(self, path: str):
        if self._store is None:
            raise RuntimeError("no stage-1 device store to checkpoint")
        self._store.save_checkpoint(path)
        np.savez(
            path + ".meta",
            sig_map=self._sig_map,
            n_used_bins=self._n_used_bins,
            n_reads=self._n_reads,
            kmer_len=self._s1.kmer_len,
            signature_len=self._s1.signature_len,
            canonical=self._s1.canonical_kmers,
        )

    def resume_stage1_checkpoint(self, path: str, params: Stage1Params):
        """Load a checkpoint written by this package or by kmc_tpu; k,
        signature length and strandedness come from the checkpoint, the
        store's capacity from params' -m plan."""
        from .ops.store import DeviceKmerStore

        meta = np.load(path + ".meta.npz")
        params.kmer_len = int(meta["kmer_len"])
        params.signature_len = int(meta["signature_len"])
        params.canonical_kmers = bool(meta["canonical"])
        params.validate()
        params.check_ported()
        self._s1 = params
        self._n_reads = int(meta["n_reads"])
        self._store = DeviceKmerStore.load_checkpoint(
            path, capacity_rows=self._memory_plan(params).device_store_rows,
            device=self.device)
        self._sig_map = self._store.host_sig_map()
        self._n_used_bins = self._store.n_used_bins
        self.n_compactions = 0
        self.spill_stats = self._spill_stats(self._store)

    # ---------------- stage 2 ----------------
    def run_stage2(self, params: Stage2Params) -> Stage2Results:
        params.validate()
        params.check_ported()
        if self._s1 is None or self._store is None:
            raise RuntimeError("run_stage1 first")
        t0 = time.perf_counter()
        results = Stage2Results()
        self._run_stage2_device_store(params, results)
        results.time = time.perf_counter() - t0
        return results

    def _make_db_info(self, params: Stage2Params) -> DbInfo:
        s1 = self._s1
        k = s1.kmer_len
        n_est_unique = 4 * self._n_reads  # KMC's heuristic, kmc.h:1436
        lut_prefix_len = pick_lut_prefix_len(k, self._n_used_bins, n_est_unique)
        counter_size = calc_counter_size(params.cutoff_max, params.counter_max)
        return DbInfo(
            kmer_len=k,
            counter_size=counter_size,
            lut_prefix_len=lut_prefix_len,
            signature_len=s1.signature_len,
            cutoff_min=params.cutoff_min,
            cutoff_max=params.cutoff_max,
            both_strands=s1.canonical_kmers,
            n_bins=self._n_used_bins,
        )

    def _run_stage2_device_store(self, params: Stage2Params,
                                 results: Stage2Results):
        """KMC2 output: the device completer emits the on-disk payload
        (mirrors kmc_tpu's _run_stage2_device_store, KMC branch)."""
        store = self._store
        n_total = store.total_occurrences()
        info = self._make_db_info(params)
        rec, lut, (n_unique, n_below, n_above) = store.finalize_records(
            cutoff_min=params.cutoff_min,
            cutoff_max=params.cutoff_max,
            counter_max=params.counter_max,
            lut_prefix_len=info.lut_prefix_len,
            counter_size=info.counter_size,
        )
        results.time_finalize_exec = store.t_finalize_exec
        results.time_finalize_d2h = store.t_finalize_d2h
        self.spill_stats = self._spill_stats(store)
        if self._s1.verbose:
            print(f"[stage2] finalize ({store.finalize_route}) exec: "
                  f"{store.t_finalize_exec:.2f}s D2H: "
                  f"{store.t_finalize_d2h:.2f}s host merge: "
                  f"{store.t_host_merge:.2f}s ({len(rec)} rows)")
        self._store = None
        results.n_unique_kmers = n_unique
        results.n_below_cutoff_min = n_below
        results.n_above_cutoff_max = n_above
        results.n_total_kmers = n_total

        t0 = time.perf_counter()
        writer = Kmc2DbWriter(params.output_file_name, info, self._sig_map)
        writer.n_unique = n_unique
        writer.n_below_min = n_below
        writer.n_above_max = n_above
        writer.n_total = n_total
        writer.write_all_records(rec, lut)
        writer.close()
        if self._s1.verbose:
            print(f"[stage2] db write: {time.perf_counter() - t0:.2f}s")


def count(
    input_files,
    output_file_name: str,
    k: int = defs.DEFAULT_K,
    device="cuda",
    **kwargs,
):
    """One-call API: returns (Stage1Results, Stage2Results).  device is
    "cuda" (default) or "cpu"; "cuda" without a card raises RuntimeError."""
    s1_keys = set(Stage1Params.__dataclass_fields__)
    s2_keys = set(Stage2Params.__dataclass_fields__)
    p1 = Stage1Params(input_files=list(input_files), kmer_len=k)
    p2 = Stage2Params(output_file_name=output_file_name)
    for key, value in kwargs.items():
        if key in s1_keys:
            setattr(p1, key, value)
        elif key in s2_keys:
            setattr(p2, key, value)
        else:
            raise TypeError(f"unknown parameter {key}")
    r = Runner(device=device)
    p2.validate()
    p2.check_ported()  # before stage 1 spends its time
    res1 = r.run_stage1(p1)
    res2 = r.run_stage2(p2)
    return res1, res2
