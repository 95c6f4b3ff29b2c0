"""Orchestrator: the two-stage counting pipeline and its public API.

The port's counterpart of kmc_tpu/runner.py, with the same parameters,
results and fluent setters (KMC's kmc_runner.h:100-255), over kmc_tpu's
single-device routes:

  device store (the default, k >= 14)
    stage 0  (eager greedy signature map only) as on the host-bucket route;
    stage 1  parse -> BatchStream -> pack_codes_boundaries -> device store
             ingest (fused ingest kernel), compacting (grouping-sort
             kernel) whenever the store fills and spilling the compacted
             store to host RAM (under the -m budget) when compaction frees
             too little; deferred greedy (the greedy policy's default)
             folds stage 0 into the first ingest launches and builds the
             map after the last;
    stage 2  finalize_records (spill replay, or the runs merged on the
             device a key range at a time, each range completed there)
             -> Kmc2DbWriter, or for KFF
             output and -w the words-path finalize -> KffWriter;
  host buckets (--no-device-store, k >= 14)
    stage 0  a sampled signature histogram (splitter-scan kernel) -> the
             greedy signature -> bin map (signatures.py);
    stage 1  per batch: splitter scan + grouping sort -> unique rows,
             routed by bin into host RAM;
    stage 2  per bin: merge_count_bin on the device -> Kmc2DbWriter.put_bin
             or one KFF section;
  small k (k <= 13)
    stage 1  a dense 4^k histogram on the device (ops/smallk.py);
    stage 2  thresholds -> a KMC1 database or one KFF section;
  -e / --opt-out-size: the ntCard estimator (ops/nthash.py) hashes every
    parsed chunk on the device; -e stops after stage 1 with the estimated
    histogram, --opt-out-size picks the LUT prefix length from it.

Input is FASTQ / FASTA (plain or gzip), BAM (-fbam: io/bam.py, BGZF
inflated on a thread pool, records parsed by the native runtime) or the
k-mers of KMC databases (-fkmc: kmc_db_code_chunks, one read per stored
k-mer), on every route.

Stage-1 device-store state checkpoints to .npz files in kmc_tpu's format
(save_stage1_checkpoint / resume_stage1_checkpoint), so a checkpoint
written by either package resumes in the other.
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import defs, trace
from .defs import calc_counter_size
from .device import device_name, resolve_device
from .formats.kmc_db import (DbInfo, Kmc2DbWriter, pick_lut_prefix_len,
                             write_kmc1_db)
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
from .signatures import build_signature_map, map_size, n_used_bins

MIN_DEVICE_K = 14  # k <= 13 is the small-k path (KMC1 output)


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
        self._small_k = False
        self._smallk_hist = None  # int64[4^k] on the device, mod 2^32
        self._estimator = None
        self._estimated_histogram = None
        # host-bucket route: per bin, the batches' (uint32 lanes (n, W),
        # uint32 counts) parts, their rows and their occurrences
        self._buckets = None
        self._bucket_rows = None
        self._bucket_occurrences = None
        self.n_compactions = 0  # store compactions in the last stage 1
        # spills, re-merges and the finalize route of the last count, with
        # their bytes and times (set by stage 1, completed by stage 2)
        self.spill_stats: dict = {}
        # the totals of the spans of the last run_stage1 / run_stage2 pair
        self._count = trace.Count()

    # ---------------- stage 1 ----------------
    def run_stage1(self, params: Stage1Params) -> Stage1Results:
        params.validate()
        self._s1 = params
        self._count = trace.Count()
        results = Stage1Results()
        with trace.span("kmc.stage1", count=self._count, usage=True):
            self._stage1(params, results)
        results.time = self._count.seconds("kmc.stage1")
        return results

    def _stage1(self, params: Stage1Params, results: Stage1Results):
        k = params.kmer_len
        self._small_k = k < MIN_DEVICE_K
        self._estimator = None
        self.n_compactions = 0
        self.spill_stats = {}  # the device-store route sets them
        if params.estimate_histogram_cfg != EstimateHistogramCfg.DONT_ESTIMATE:
            if self._small_k:
                raise ValueError(
                    "histogram estimation not supported with small-k "
                    "optimization")  # kmc.h:779-785
            from .ops.nthash import NtCardEstimator

            # sampling prefix width by predicted input size (kmc.h:
            # 1118-1121: s = 7 under 50 GB, s = 11 above)
            predicted = sum(Path(p).stat().st_size
                            for p in params.input_files if Path(p).exists())
            self._estimator = NtCardEstimator(
                k, s=7 if predicted < 50_000_000_000 else 11,
                device=self.device)
        if params.estimate_histogram_cfg == EstimateHistogramCfg.ONLY_ESTIMATE:
            for chunk, _ in self._chunks(params):
                self._estimator.process_codes(chunk)
        elif self._small_k:
            self._run_stage1_small_k(params)
        elif params.device_store:
            self._run_stage1_device_store(params, results)
        else:
            # host buckets route by bin during stage 1, so the map must
            # exist up front: KMC's sampled stage 0
            self._run_stage0(params)
            self._run_stage1_host_buckets(params)
        if self._estimator is not None:
            results.estimated_histogram = self._estimator.estimate_histogram()
            self._estimated_histogram = results.estimated_histogram
            self._estimator = None  # frees the counters
        results.n_sequences = self._n_reads
        results.was_small_k_opt_used = self._small_k

    def _memory_plan(self, params: Stage1Params):
        """The -m carve for this run; also sizes the parse chunks.  As in
        kmc_tpu, only the device-store route applies it: the other routes
        parse with the chunk size in force."""
        plan = plan_memory(
            params.max_ram_gb, k=params.kmer_len,
            batch_positions=params.batch_positions,
            n_threads=params.n_threads or n_cpus(),
            strict_memory=params.strict_memory_mode,
            requested_rows=params.device_store_rows)
        set_chunk_bytes(plan.parse_chunk_bytes)
        return plan

    def _chunks(self, params: Stage1Params, max_bytes=None):
        """Parsed code chunks, as kmc_tpu cuts them: the estimator of
        --opt-out-size hashes each chunk of the full parse alone, so the
        chunks must be kmc_tpu's (the same readers, the same chunk bytes).
        max_bytes: stage 0's sample of text input, read serially (BAM and
        KMC-database input are read whole, as in kmc_tpu)."""
        state = ParseState()
        fmt = params.input_file_type.value
        feed_estimator = (
            max_bytes is None and self._estimator is not None
            and params.estimate_histogram_cfg
            == EstimateHistogramCfg.ESTIMATE_AND_COUNT_KMERS)
        # -sf bounds the reader pool independently of -t
        n_th = params.n_reader_threads or params.n_threads or n_cpus()
        if fmt == "bam":
            source = bam_chunks(params.input_files, state,
                                both_strands=params.canonical_kmers,
                                n_threads=n_th)
        elif fmt == "kmc":
            source = kmc_db_code_chunks(params.input_files, state)
        elif n_th > 1 and max_bytes is None:
            # N parser threads over record-aligned shards; the chunk stream
            # is a boundary refinement of the serial one
            source = parallel_code_stream(params.input_files, fmt, state,
                                          n_threads=n_th)
        else:
            source = file_code_stream(params.input_files, fmt, state,
                                      max_bytes=max_bytes)
        if params.homopolymer_compressed:
            source = homopolymer_compress_stream(source)
        for chunk in source:
            if feed_estimator:
                self._estimator.process_codes(chunk)
            yield chunk, state
        self._n_reads = state.n_reads

    def _batches(self, params: Stage1Params, max_bytes=None):
        """The device batches of the parse, as uint8 numpy arrays."""
        bs = BatchStream(params.batch_positions, params.kmer_len)
        return bs.batches(c for c, _ in self._chunks(params, max_bytes))

    def _codes_on_device(self, batch: np.ndarray):
        return torch.from_numpy(batch).to(self.device)

    def _run_stage0(self, params: Stage1Params):
        """The sampled signature histogram (on the device, kmc_tpu's
        _run_stage0) -> the greedy signature -> bin map."""
        from .ops.sortcount import stage0_accum

        m = params.signature_len
        with trace.span("kmc.stage0") as hist_span:
            hist = torch.zeros(map_size(m), dtype=torch.int64,
                               device=self.device)
            for batch in self._batches(params,
                                       max_bytes=defs.STATS_SAMPLE_BYTES):
                stage0_accum(self._codes_on_device(batch), hist,
                             s=params.batch_positions, k=params.kmer_len,
                             sig_len=m)
            hist = hist.cpu().numpy().astype(np.uint64)
        with trace.span("kmc.map_build") as map_span:
            self._sig_map = build_signature_map(hist, m, params.n_bins)
            self._n_used_bins = n_used_bins(self._sig_map)
        if params.verbose:
            print(f"[stage0] signature map: "
                  f"{hist_span.seconds + map_span.seconds:.2f}s "
                  f"(histogram {hist_span.seconds:.2f}s)")

    def _run_stage1_host_buckets(self, params: Stage1Params):
        """Unique rows of each batch (splitter scan + grouping sort on the
        device), routed by bin into host RAM (kmc_tpu's
        _run_stage1_host_buckets: a stable sort by bin in each batch)."""
        from .ops.sortcount import stage1_batch

        n_bins = self._n_used_bins
        buckets = [[] for _ in range(n_bins)]
        bucket_rows = np.zeros(n_bins, dtype=np.int64)
        bucket_occ = np.zeros(n_bins, dtype=np.int64)
        sig_to_bin = torch.from_numpy(self._sig_map.astype(np.int64)).to(
            self.device)
        for batch in self._batches(params):
            sig, lanes, counts = stage1_batch(
                self._codes_on_device(batch), s=params.batch_positions,
                k=params.kmer_len, sig_len=params.signature_len,
                both_strands=params.canonical_kmers)
            keep = sig != -1  # INVALID_SIG as an int32
            bins = sig_to_bin[sig[keep].to(torch.int64)]
            bins, order = torch.sort(bins, stable=True)
            words = torch.stack([c[keep][order] for c in lanes], dim=1)
            counts = counts[keep][order]
            rows = torch.bincount(bins, minlength=n_bins)
            occ = torch.zeros(n_bins, dtype=torch.int64,
                              device=self.device).index_add_(0, bins, counts)
            words = words.cpu().numpy().view(np.uint32)
            counts = counts.cpu().numpy().astype(np.uint32)
            rows = rows.cpu().numpy()
            bounds = np.concatenate([[0], np.cumsum(rows)])
            for b in np.flatnonzero(rows):
                lo, hi = bounds[b], bounds[b + 1]
                buckets[b].append((words[lo:hi], counts[lo:hi]))
            bucket_rows += rows
            bucket_occ += occ.cpu().numpy()
        self._buckets = buckets
        self._bucket_rows = bucket_rows
        self._bucket_occurrences = bucket_occ

    def _run_stage1_small_k(self, params: Stage1Params):
        """The dense 4^k histogram on the device (kmc_tpu's
        _run_stage1_small_k)."""
        from .ops.smallk import smallk_batch, smallk_histogram_size

        k, s = params.kmer_len, params.batch_positions
        hist = torch.zeros(smallk_histogram_size(k), dtype=torch.int64,
                           device=self.device)
        for batch in self._batches(params):
            smallk_batch(self._codes_on_device(pack_codes_fused(batch)), hist,
                         s=s, k=k, both_strands=params.canonical_kmers)
        # kmc_tpu's u32 histogram wraps; the invalid slot is dropped
        self._smallk_hist = hist.bitwise_and_(0xFFFFFFFF)[:-1]

    def _run_stage1_device_store(self, params: Stage1Params,
                                 results: Stage1Results):
        """Parse on the host, count on the device (mirrors kmc_tpu's
        _run_stage1_device_store).  Greedy policy: eager greedy runs stage
        0 first and bins every batch through the map; deferred greedy
        (KMC_TPU_GREEDY_DEFER, the default) adds the signatures of the
        first KMC_TPU_STAGE0_SAMPLE_POSITIONS positions (2^27 by default,
        whole batches) to the stage-0 histogram in the ingest launches
        themselves and builds the map after the last batch."""
        from .ops.store import DeviceKmerStore, greedy_defer_default

        k, m = params.kmer_len, params.signature_len
        s = params.batch_positions
        bs = BatchStream(s, k)
        with trace.span("kmc.store_setup"):
            plan = self._memory_plan(params)
            capacity = max(plan.device_store_rows, 2 * s)
            # the card holds the whole store from the start; on the CPU
            # (tests) it starts small and grows
            init_rows = capacity if self.device.type == "cuda" else 2 * s
            greedy = params.signature_map_policy == "greedy"
            fold = greedy and greedy_defer_default()
            store_kw = dict(map_mode=params.signature_map_policy,
                            n_bins=params.n_bins)
            if greedy:
                store_kw["greedy_defer"] = fold
                if not fold:  # eager: the map before the first batch
                    self._run_stage0(params)
                    store_kw["sig_map"] = self._sig_map
            store = DeviceKmerStore(
                capacity, k=k, sig_len=m, both_strands=params.canonical_kmers,
                initial_rows=init_rows,
                spill_budget_bytes=plan.spill_budget_bytes,
                device=self.device, **store_kw)
            # the deferred fold's histogram, on the device
            hist = (torch.zeros(map_size(m), dtype=torch.int32,
                                device=self.device) if fold else None)
            trace.add("rows", store.capacity)
        sample_cap = int(os.environ.get("KMC_TPU_STAGE0_SAMPLE_POSITIONS",
                                        str(1 << 27)))
        sampled = 0
        total_bytes = sum(
            Path(p).stat().st_size for p in params.input_files if Path(p).exists()
        )
        ppo = params.percent_progress_observer
        if ppo is not None:
            ppo.set_label("Stage 1: ")
        state_ref = None
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
        started_by = trace.current()

        def worker():
            nonlocal sampled
            with trace.span("kmc.ingest_worker", parent=started_by,
                            usage=True):
                try:
                    while True:
                        with trace.span("kmc.queue_get"):
                            item = q.get()
                        if item is None:
                            return
                        h = hist if fold and sampled < sample_cap else None
                        store.ingest_packed(item, s=s, hist=h)
                        if h is not None:
                            sampled += s
                except BaseException as e:  # noqa: BLE001 - re-raised
                    errors.append(e)
                    while q.get() is not None:  # unblock the producer
                        pass

        th = threading.Thread(target=worker, name="kmc-ingest", daemon=True)
        th.start()
        batches = bs.batches(gen())
        try:
            while True:
                # the stream's next batch: the wait on the reader pool, the
                # batch assembly and the pool's start
                with trace.span("kmc.next_batch"):
                    batch = next(batches, None)
                if batch is None:
                    break
                # boundary-delta feed when sentinels are sparse; packed+mask
                # for sentinel-dense batches
                with trace.span("kmc.pack"):
                    buf, ts = pack_codes_boundaries(batch)
                    if buf is not None:
                        item = ("b", buf, ts)
                        trace.add("boundary")
                    else:
                        item = ("m", pack_codes_fused(batch))
                        trace.add("mask")
                if errors:
                    break
                with trace.span("kmc.queue_put"):
                    q.put(item)
                if ppo is not None and total_bytes and state_ref is not None:
                    ppo.set_progress(
                        min(99, state_ref.consumed_bytes * 100 // total_bytes)
                    )
        finally:
            # always deliver the sentinel, so a parse error cannot leave the
            # worker blocked on the queue
            with trace.span("kmc.ingest_drain"):
                q.put(None)
                th.join()
        if errors:
            raise errors[0]
        if ppo is not None:
            ppo.set_progress(100)
        if fold:
            with trace.span("kmc.map_build") as map_span:
                counts = hist.cpu().numpy().view(np.uint32).astype(np.uint64)
                store.set_sig_map(build_signature_map(counts, m,
                                                      params.n_bins))
            if params.verbose:
                print(f"[stage0] folded signature map ({sampled} sampled "
                      f"positions): {map_span.seconds:.2f}s")
        self._store = store
        self.n_compactions = self._count.calls("kmc.compact")
        self.spill_stats = self._spill_stats(store)
        if params.verbose:
            c, st = self._count, self.spill_stats
            host = c.seconds("kmc.parse_wait", "kmc.assemble", "kmc.pack")
            print(f"[stage1] on {device_name(self.device)}: "
                  f"host(parse+pack): {host:.2f}s "
                  f"queue-wait: {c.seconds('kmc.queue_put'):.2f}s "
                  f"({c.counter('positions') // max(s, 1)} batches, "
                  f"{self.n_compactions} compactions, {st['n_spills']} "
                  f"spills of {st['spill_bytes']} bytes, spill D2H "
                  f"{st['t_spill_d2h']:.2f}s, {st['n_remerges']} re-merges "
                  f"{st['t_remerge']:.2f}s)")
        self._sig_map = store.host_sig_map()
        self._n_used_bins = store.n_used_bins
        results.n_total_super_kmers = store.total_super_kmers()

    def _spill_stats(self, store) -> dict:
        """The spills, re-merges and merges of the count so far, from its
        spans' totals, and the store's finalize route."""
        c = self._count
        return dict(n_spills=c.calls("kmc.spill"),
                    spill_bytes=c.counter("bytes", "kmc.spill_d2h"),
                    t_spill_d2h=c.seconds("kmc.spill_wait", "kmc.spill_d2h"),
                    n_remerges=c.calls("kmc.remerge"),
                    t_remerge=c.seconds("kmc.remerge"),
                    t_host_merge=c.seconds("kmc.host_merge"),
                    merge_launches=c.counter("sort_launches", "kmc.remerge",
                                             "kmc.host_merge"),
                    collect_launches=c.counter("sort_launches",
                                               "kmc.collect"),
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
        self._s1 = params
        self._count = trace.Count()  # the resumed count's spans
        self._small_k = params.kmer_len < MIN_DEVICE_K
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
        if self._s1 is None:
            raise RuntimeError("run_stage1 first")
        results = Stage2Results()
        if self._s1.estimate_histogram_cfg == EstimateHistogramCfg.ONLY_ESTIMATE:
            return results  # kmc.h:1411-1412: no stage 2 under -e
        with trace.span("kmc.stage2", count=self._count, usage=True):
            if self._small_k:
                self._run_stage2_small_k(params, results)
            elif self._s1.device_store:
                if self._store is None:
                    raise RuntimeError("run_stage1 first")
                self._run_stage2_device_store(params, results)
            else:
                self._run_stage2_host_buckets(params, results)
        results.time = self._count.seconds("kmc.stage2")
        return results

    def _make_db_info(self, params: Stage2Params) -> DbInfo:
        s1 = self._s1
        k = s1.kmer_len
        if self._estimated_histogram:
            # estimated unique k-mers within the cutoffs (kmc.h:1437-1446)
            hist = self._estimated_histogram
            end = min(params.cutoff_max + 1, len(hist))
            n_est_unique = sum(hist[params.cutoff_min:end])
        else:
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
        """KMC2 output: the device completer emits the on-disk payload;
        KFF output and -w: the words-path finalize (mirrors kmc_tpu's
        _run_stage2_device_store)."""
        store = self._store
        n_total = store.total_occurrences()
        if params.without_output or params.output_file_type == OutputFileType.KFF:
            bins, words, counts, (n_unique, n_below, n_above) = store.finalize(
                cutoff_min=params.cutoff_min, cutoff_max=params.cutoff_max,
                counter_max=params.counter_max)
            # as kmc_tpu's words-path finalize times only the device routes
            results.time_finalize_exec = self._count.seconds(
                "kmc.finalize_exec")
            results.time_finalize_d2h = self._count.seconds(
                "kmc.finalize_d2h")
            self.spill_stats = self._spill_stats(store)
            self._store = None
            results.n_unique_kmers = n_unique
            results.n_below_cutoff_min = n_below
            results.n_above_cutoff_max = n_above
            results.n_total_kmers = n_total
            if params.without_output:
                return
            write_kff_sections(self._kff_writer(params), bins, words, counts,
                               k=self._s1.kmer_len, n_bins=self._n_used_bins)
            return
        info = self._make_db_info(params)
        rec, lut, (n_unique, n_below, n_above) = store.finalize_records(
            cutoff_min=params.cutoff_min,
            cutoff_max=params.cutoff_max,
            counter_max=params.counter_max,
            lut_prefix_len=info.lut_prefix_len,
            counter_size=info.counter_size,
        )
        # the host route's merge and completer count as its execution
        c = self._count
        results.time_finalize_exec = c.seconds("kmc.finalize_exec",
                                               "kmc.host_route")
        results.time_finalize_d2h = c.seconds("kmc.finalize_d2h")
        self.spill_stats = self._spill_stats(store)
        if self._s1.verbose:
            print(f"[stage2] finalize ({store.finalize_route}) exec: "
                  f"{results.time_finalize_exec:.2f}s D2H: "
                  f"{results.time_finalize_d2h:.2f}s host merge: "
                  f"{self.spill_stats['t_host_merge']:.2f}s "
                  f"({len(rec)} rows)")
        self._store = None
        results.n_unique_kmers = n_unique
        results.n_below_cutoff_min = n_below
        results.n_above_cutoff_max = n_above
        results.n_total_kmers = n_total

        with trace.span("kmc.write") as write_span:
            writer = Kmc2DbWriter(params.output_file_name, info,
                                  self._sig_map)
            writer.n_unique = n_unique
            writer.n_below_min = n_below
            writer.n_above_max = n_above
            writer.n_total = n_total
            writer.write_all_records(rec, lut)
            writer.close()
        if self._s1.verbose:
            print(f"[stage2] db write: {write_span.seconds:.2f}s")

    def _kff_writer(self, params: Stage2Params):
        """A KFF writer for the output (KMC's completer KFF path,
        kb_completer.cpp:172-177)."""
        from .formats.kff import KffWriter

        return KffWriter(
            params.output_file_name + ".kff",
            canonical=self._s1.canonical_kmers, k=self._s1.kmer_len,
            counter_size=calc_counter_size(params.cutoff_max,
                                           params.counter_max),
            min_count=params.cutoff_min, max_count=params.cutoff_max)

    def _run_stage2_host_buckets(self, params: Stage2Params,
                                 results: Stage2Results):
        """Each bin's rows merged on the device (merge_count_bin), written
        bin by bin as KMC2 or as one KFF section each (kmc_tpu's
        _run_stage2_host_buckets)."""
        from .ops.sortcount import merge_count_bin

        k = self._s1.kmer_len
        info = self._make_db_info(params)
        writer = kff = None
        if not params.without_output:
            if params.output_file_type == OutputFileType.KFF:
                kff = self._kff_writer(params)
            else:
                writer = Kmc2DbWriter(params.output_file_name, info,
                                      self._sig_map)
        for b in range(self._n_used_bins):
            parts = self._buckets[b]
            if not int(self._bucket_rows[b]):
                continue
            # kmc_tpu pads each bin to a power of two for its static
            # shapes; rows of count 0 add nothing, so none are added here
            words = np.concatenate([w for w, _ in parts]).view(np.int32)
            counts = np.concatenate([c for _, c in parts]).view(np.int32)
            kept, kept_counts, (n_unique, n_below, n_above) = merge_count_bin(
                [torch.from_numpy(np.ascontiguousarray(words[:, t])).to(
                    self.device) for t in range(words.shape[1])],
                torch.from_numpy(counts).to(self.device),
                cutoff_min=params.cutoff_min, cutoff_max=params.cutoff_max,
                counter_max=params.counter_max)
            kw = kept.cpu().numpy().astype(np.uint32)
            kc = kept_counts.cpu().numpy().astype(np.uint32)
            n_total = int(self._bucket_occurrences[b])
            results.n_unique_kmers += n_unique
            results.n_below_cutoff_min += n_below
            results.n_above_cutoff_max += n_above
            results.n_total_kmers += n_total
            if writer is not None:
                writer.put_bin(b, words_to_kmer_bytes(kw, k), kc, stats={
                    "n_unique": n_unique, "n_below_min": n_below,
                    "n_above_max": n_above, "n_total": n_total})
            elif kff is not None:
                kff.store_section(words_to_kmer_bytes(kw, k), kc)
            self._buckets[b] = None  # free as we go
        with trace.span("kmc.write"):
            if writer is not None:
                writer.close()
            if kff is not None:
                kff.close()

    def _run_stage2_small_k(self, params: Stage2Params,
                            results: Stage2Results):
        s1 = self._s1
        (results.n_unique_kmers, results.n_below_cutoff_min,
         results.n_above_cutoff_max, results.n_total_kmers) = \
            smallk_finalize_and_write(
                self._smallk_hist, s1.kmer_len,
                cutoff_min=params.cutoff_min, cutoff_max=params.cutoff_max,
                counter_max=params.counter_max, canonical=s1.canonical_kmers,
                output_file_name=params.output_file_name,
                output_kff=params.output_file_type == OutputFileType.KFF,
                write=not params.without_output)
        self._smallk_hist = None


def bam_chunks(paths, state, *, both_strands: bool, n_threads: int):
    """-fbam input: each file's code chunks (io/bam.py), with its reads
    added to state.n_reads; n_threads inflate the BGZF blocks."""
    from .io.bam import bam_code_chunks

    for path in paths:
        for codes, n_reads in bam_code_chunks(path, both_strands,
                                              n_threads=n_threads):
            state.n_reads += n_reads
            yield codes


def kmc_db_code_chunks(paths, state):
    """-fkmc input: every k-mer stored in the database becomes one read
    of k_in codes and a separator (counters ignored), matching
    CBinaryFilesReader::ProcessKMC (binary_reader.h:238-305)."""
    from .formats.kmc_db import read_db

    for path in paths:
        db = read_db(path)
        kmers = db.kmers_bytes()
        k_in = db.info.kmer_len
        block = 1 << 16
        for lo in range(0, len(kmers), block):
            rows = kmers[lo : lo + block]
            n, kb = rows.shape
            codes = np.empty((n, kb * 4), np.uint8)
            codes[:, 0::4] = (rows >> 6) & 3
            codes[:, 1::4] = (rows >> 4) & 3
            codes[:, 2::4] = (rows >> 2) & 3
            codes[:, 3::4] = rows & 3
            out = np.full((n, k_in + 1), defs.CODE_INVALID, np.uint8)
            out[:, :k_in] = codes[:, kb * 4 - k_in :]
            state.n_reads += n
            yield out.reshape(-1)


def smallk_finalize_and_write(hist: torch.Tensor, k: int, *, cutoff_min,
                              cutoff_max, counter_max, canonical,
                              output_file_name, output_kff=False,
                              write=True):
    """The small-k (k <= 13) finalize (kmc_tpu's smallk_finalize_and_write;
    KMC's CSmallKCompleter, kb_completer.h:92, kmc.h:677-970): threshold
    the dense histogram (int64[4^k] of u32 counts, on its device) and
    write a KMC1 database or one KFF section.  Returns (n_unique, n_below,
    n_above, n_total)."""
    nonzero = torch.nonzero(hist).squeeze(1)
    cnts = hist[nonzero]
    below = cnts < cutoff_min
    above = cnts > cutoff_max
    keep = ~below & ~above
    kmers_int = nonzero[keep].cpu().numpy().astype(np.uint64)
    counts = torch.clamp(cnts[keep], max=counter_max).cpu().numpy().astype(
        np.uint32)
    stats = (nonzero.shape[0], int(below.sum()), int(above.sum()),
             int(cnts.sum()))
    if not write:
        return stats
    counter_size = calc_counter_size(cutoff_max, counter_max)
    kb = (k + 3) // 4
    kmer_bytes = np.zeros((len(kmers_int), kb), dtype=np.uint8)
    v = kmers_int.copy()
    for j in range(kb - 1, -1, -1):
        kmer_bytes[:, j] = (v & np.uint64(0xFF)).astype(np.uint8)
        v >>= np.uint64(8)
    if output_kff:
        from .formats.kff import KffWriter

        w = KffWriter(output_file_name + ".kff", canonical=canonical, k=k,
                      counter_size=counter_size, min_count=cutoff_min,
                      max_count=cutoff_max)
        w.store_section(kmer_bytes, counts)
        w.close()
    else:
        info = DbInfo(
            kmer_len=k, counter_size=counter_size,
            lut_prefix_len=pick_lut_prefix_len(k, 1, len(kmers_int),
                                               kmc1=True),
            cutoff_min=cutoff_min, cutoff_max=cutoff_max,
            both_strands=canonical, version=0)
        write_kmc1_db(output_file_name, info, kmer_bytes, counts)
    return stats


def write_kff_sections(writer, bins, words, counts, *, k: int, n_bins: int):
    """Write the words-path finalize's rows (bins, words, counts in (bin,
    k-mer) order) as one raw section per bin that keeps a k-mer (KMC's
    completer KFF path, kb_completer.cpp:172-177), then close the
    writer."""
    bounds = np.searchsorted(bins, np.arange(n_bins + 1))
    kmer_bytes = words_to_kmer_bytes(words, k)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if lo < hi:
            writer.store_section(kmer_bytes[lo:hi], counts[lo:hi])
    writer.close()


def words_to_kmer_bytes(words: np.ndarray, k: int) -> np.ndarray:
    """(N, W) uint32 MSW-first lanes -> (N, KB) right-aligned big-endian
    bytes (kmc_tpu's words_to_kmer_bytes)."""
    n, W = words.shape
    kb = (k + 3) // 4
    b = np.ascontiguousarray(words).astype(">u4").view(np.uint8).reshape(
        n, 4 * W)
    return np.ascontiguousarray(b[:, 4 * W - kb:])


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
    res1 = r.run_stage1(p1)
    res2 = r.run_stage2(p2)
    return res1, res2
