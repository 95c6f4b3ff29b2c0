"""Multi-device counting: kmc_tpu/parallel/multihost.py's distributed_count on torch.

One process drives D shards of the store, each a DeviceKmerStore
(ops/store.py) on its own device; a device may hold several shards.

  ingest    batches are dealt round-robin to the shards, one group of D
            batches at a time; each shard runs the single-device ingest
            (splitter-scan kernel) on its batch.  The super-k-mer carry
            (the previous batch's last signature) is threaded through the
            shards in deal order, so the totals equal the single-device
            runner's.
  compact   when the fullest shard cannot take another batch, every shard
            merges its duplicates (grouping-sort kernel), kmc_tpu's
            schedule.
  spill     when the fullest shard still cannot take the batch after that,
            every shard's live rows go to host RAM, each shard's sorted by
            its key columns as a run of its own, and every shard starts
            empty.  The runs are held to the -m plan's spill budget by
            kmc_tpu's figure (8 + 4W + 4 bytes a row: an int64 bin, W
            words, a u32 count): spills past it are re-merged into one run
            (ops/store.py's merge_runs, on the first shard's device, totals
            clamped at 0xFFFFFFFF), and a merged run still past it raises
            MemoryError naming -m.
  finalize  owner o holds the contiguous bin range [bounds[o],
            bounds[o+1]), balanced from the live rows' per-bin histogram.
            Each sender sorts its live rows by key column 0 (which carries
            the bin), cuts them into owner segments of `capacity` rows, and
            the exchange kernel (parallel/exchange_kernel.py) moves them to
            the owners.  Each owner runs the single-device group-reduce over
            what it received; after spills it then merges its groups with
            the spilled rows of its own bin range on its own device (u64
            sums clamped at 0xFFFFFFFF, as kmc_tpu's finalize merges them),
            and runs the completer.  Its records are in (bin, k-mer) order
            and its bins follow the previous owner's, so the host
            concatenates the owners' records and sums their LUTs and stats.
            The database is byte-identical to the single-device count's (and
            to kmc_tpu's).

Before the first compaction a row weighs 1 and only the key columns cross;
after one, the counts ride along as one more column.

The other modes follow kmc_tpu's distributed_count in one process:
  greedy    signature_map_policy="greedy": a sampled stage 0 (the serial
            stream's first STATS_SAMPLE_BYTES, the splitter-scan kernel's
            signatures) builds the map before the ingest, and every shard
            ingests through the fused ingest's greedy entry (eager greedy,
            as kmc_tpu's sharded store is).
  KFF       output_type="kff": the words-path finalize (finalize) runs the
            same exchange and owner reductions and writes one raw section
            per non-empty bin.
  small k   k <= 13: each shard adds its batches into a dense histogram
            on its own device; the histograms are summed on the first
            shard's device, mod 2^32 as kmc_tpu's u32 sum wraps, and
            written as KMC1 or KFF.
  -e        estimate_only / opt_out_size: the ntCard sketch on the first
            shard's device hashes the chunk stream the count ingests, in
            kmc_tpu's order; -e writes nothing, --opt-out-size takes the
            LUT width from the estimate.
Multi-process runs (torch.distributed) are ROADMAP A11c.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..defs import MAX_K, STATS_SAMPLE_BYTES, calc_counter_size
from ..io.readers import homopolymer_compress_stream
from ..ops.extract import i32_to_u32, u32_to_i32
from ..ops.sort_kernel import radix_sort_columns
from ..ops.store import (DeviceKmerStore, _completer, _cutoffs, _group_reduce,
                         _host_u32, _split_bins, merge_runs, remerge_runs)
from ..runner import MIN_DEVICE_K, n_cpus
from .distributed import resolve_devices
from .exchange_kernel import ragged_all_to_all


def _round_pow2(x: int, lo: int = 64) -> int:
    """Round up to {1, 1.25, 1.5, 1.75} x 2^k, 128-aligned (mirrors
    kmc_tpu's _round_pow2, which bounds its compiled shapes): the exchange
    segments' capacity."""
    n = lo
    while n < x:
        n *= 2
    if n <= max(x, lo):
        return n
    half = n // 2
    for frac in (1.25, 1.5, 1.75):
        c = (int(half * frac) + 127) & ~127
        if c >= x:
            return c
    return n


def _sync(devices) -> None:
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


class ShardedKmerStore:
    """The store split into shards, one DeviceKmerStore per entry of
    `devices` (mirrors kmc_tpu's ShardedKmerStore in one process; see the
    module docstring)."""

    def __init__(self, devices, capacity_rows_per_device: int, *, k: int,
                 sig_len: int = 9, both_strands: bool = True,
                 n_bins: int = 512, initial_rows: int | None = None,
                 map_mode: str = "prefix", sig_map: np.ndarray | None = None,
                 spill_budget_bytes: int | None = None):
        """map_mode "prefix" or "greedy" (sig_map, from
        signatures.build_signature_map, required: every shard bins its
        batches through it as it ingests them, kmc_tpu's eager sharded
        greedy).  spill_budget_bytes: the -m plan's budget for spilled rows
        (None sets none)."""
        if map_mode == "greedy" and sig_map is None:
            raise ValueError("greedy map_mode requires sig_map")
        self.devices = resolve_devices(devices)
        self.D = len(self.devices)
        self.cap = int(capacity_rows_per_device)
        greedy = dict(sig_map=sig_map, greedy_defer=False) \
            if map_mode == "greedy" else {}
        self._sig_map = None if sig_map is None else np.asarray(
            sig_map).astype(np.int32)
        self.shards = [
            DeviceKmerStore(self.cap, k=k, sig_len=sig_len,
                            both_strands=both_strands, n_bins=n_bins,
                            map_mode=map_mode, initial_rows=initial_rows,
                            device=dev, **greedy)
            for dev in self.devices]
        first = self.shards[0]
        self.k = first.k
        self.r0 = first.r0
        self.fuse = first.fuse
        self.n_cols = first.n_cols
        self.n_used_bins = first.n_used_bins
        self.W = first.W
        # kmc_tpu's spilled row: an int64 bin, W u32 words and a u32 count
        self.spill_row_bytes = 8 + 4 * self.W + 4
        self._rows_per_device = 0  # rows of the fullest shard
        self._carry = None  # last signature of the latest ingested batch
        self.n_compactions = 0
        self.exchange_bytes = 0  # bytes the exchange read and wrote
        # host-side spilled rows: per spill, each shard's sorted run
        # (uint32 key columns tuple, uint32 counts)
        self.spilled: list[list] = []
        self.spill_budget_bytes = spill_budget_bytes
        self.n_spills = 0
        self.n_remerges = 0
        self.merge_launches = 0  # grouping-sort launches of the merges
        self.timings: dict[str, float] = dict(spill_s=0.0, remerge_s=0.0)

    # -- ingest --

    def ingest_group(self, items, *, s: int):
        """Ingest one group: items[d] is shard d's packed batch, ("b", buf,
        tail_start) in the boundary-delta feed or ("m", buf) in the
        packed+mask feed; a last group may hold fewer than D."""
        if self._rows_per_device + s > self.cap:
            self.compact()
            if self._rows_per_device + s > self.cap:
                self.spill()
        for shard, item in zip(self.shards, items):
            if self._carry is not None:
                shard.prev_sig = self._carry.to(shard.device)
            if item[0] == "b":
                shard.ingest_boundaries(item[1], item[2], s=s)
            else:
                shard.ingest_fused(item[1], s=s)
            self._carry = shard.prev_sig
        self._rows_per_device += s

    def compact(self):
        """Merge duplicates on every shard (materializes the counts)."""
        for shard in self.shards:
            shard.compact()
        self.n_compactions += 1
        self._rows_per_device = max(sh.n_used for sh in self.shards)

    # -- spill to host RAM under the -m budget --

    def spill(self):
        """Move every shard's live rows to host RAM, each shard's as one run
        sorted by its key columns, and start every shard empty (mirrors
        kmc_tpu's spill, which pulls the live rows as they stand: no
        compaction first); then hold the runs to the budget."""
        t0 = time.perf_counter()
        runs = []
        for shard in self.shards:
            shard._materialize_counts()
            cols, counts = shard._live_rows()
            rows = radix_sort_columns(cols + [counts], self.n_cols)
            runs.append((tuple(_host_u32(c) for c in rows[:-1]),
                         _host_u32(rows[-1])))
            shard.n_used = 0
            shard._since_compact = 0
        self.timings["spill_s"] += time.perf_counter() - t0
        self.spilled.append(runs)
        self.n_spills += 1
        self._rows_per_device = 0
        self._enforce_spill_budget()

    def _spilled_bytes(self) -> int:
        """The spilled rows' bytes as kmc_tpu counts them."""
        return self.spill_row_bytes * sum(
            len(counts) for runs in self.spilled for _, counts in runs)

    def _enforce_spill_budget(self):
        """-m enforcement (mirrors kmc_tpu): re-merge the spills when their
        bytes cross the budget; one merged run still over it means the
        unique set does not fit -m."""
        b = self.spill_budget_bytes
        if b is None or self._spilled_bytes() <= b:
            return
        if len(self.spilled) > 1:
            self._remerge_spilled()
        if self._spilled_bytes() > b:
            raise MemoryError(
                f"unique k-mer set exceeds the -m/max_ram_gb host budget "
                f"({self._spilled_bytes()} spilled bytes > {b}); raise -m")

    def _remerge_spilled(self):
        """Collapse every spilled run into one sorted unique run, merged on
        the first shard's device; totals clamp at 0xFFFFFFFF (kmc_tpu's
        _remerge_spilled)."""
        t0 = time.perf_counter()
        launches = radix_sort_columns.launches
        runs = [run for spill in self.spilled for run in spill]
        self.spilled = [[remerge_runs(runs, self.n_cols, self.devices[0])]]
        self.merge_launches += radix_sort_columns.launches - launches
        self.n_remerges += 1
        self.timings["remerge_s"] += time.perf_counter() - t0

    def total_occurrences(self) -> int:
        return sum(sh.total_occurrences() for sh in self.shards)

    def total_super_kmers(self) -> int:
        return sum(sh.total_super_kmers() for sh in self.shards)

    def host_sig_map(self) -> np.ndarray:
        """The .kmc_pre footer's map: a greedy map as it was given, -1
        slots and all (kmc_tpu's sharded host_sig_map)."""
        if self._sig_map is not None:
            return self._sig_map
        return self.shards[0].host_sig_map()

    # -- finalize --

    def _bins(self, col0: torch.Tensor) -> torch.Tensor:
        """Bin ids (int64) of key column 0."""
        c0 = i32_to_u32(col0)
        return c0 >> (2 * self.r0) if self.fuse else c0

    def _owner_plan(self, hist: np.ndarray) -> tuple[int, np.ndarray]:
        """(capacity, bounds) from the per-sender bin histogram
        int64[D, n_used_bins + 1] (mirrors kmc_tpu's _owner_plan): owner
        boundaries where the cumulative load reaches each owner's even
        share, and the largest (sender, owner) segment rounded up."""
        D = self.D
        nh = hist.shape[1]
        cum = np.concatenate([np.zeros(1, np.int64), np.cumsum(hist.sum(0))])
        targets = (int(cum[-1]) * np.arange(1, D, dtype=np.int64)) // D
        inner = np.searchsorted(cum, targets, side="left")
        bounds = np.concatenate([[0], inner, [nh]]).astype(np.int64)
        pc = np.concatenate([np.zeros((D, 1), np.int64),
                             np.cumsum(hist, axis=1)], axis=1)
        seg = pc[:, bounds[1:]] - pc[:, bounds[:-1]]
        return _round_pow2(int(seg.max()) if seg.size else 64), bounds

    def _received_rows(self):
        """Exchange: returns (per owner (key columns, counts or None) of the
        rows it owns, from every shard; the owners' bin bounds, None for
        one owner)."""
        D = self.D
        t0 = time.perf_counter()
        senders = [sh._live_rows() for sh in self.shards]
        for sh in self.shards:  # the store is consumed
            sh.key_cols = sh.counts = None
        has_counts = senders[0][1] is not None
        if D == 1:  # single owner = self: no sort, no exchange
            self.timings["owner_hist_s"] = time.perf_counter() - t0
            self.timings["exchange_groupsort_s"] = 0.0
            return senders, None
        nh = self.n_used_bins + 1
        sorted_rows, edges = [], []
        for (cols, counts), dev in zip(senders, self.devices):
            # rows in key-column-0 order are in bin order, hence in owner
            # order: each owner's rows are one slice
            rows = radix_sort_columns(
                cols + ([counts] if has_counts else []), 1)
            sorted_rows.append(rows)
            edges.append(torch.searchsorted(
                self._bins(rows[0]), torch.arange(nh + 1, device=dev)))
        del senders
        # edges[j, b]: sender j's first row of bin b or a later one
        edges = np.stack([e.cpu().numpy() for e in edges])
        cap, bounds = self._owner_plan(np.diff(edges, axis=1))
        self.timings["owner_hist_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        C = self.n_cols + int(has_counts)
        send, n_rows = [], []
        for rows, starts, dev in zip(sorted_rows, edges[:, bounds],
                                     self.devices):
            n_per_owner = np.diff(starts)
            if int(np.maximum(n_per_owner - cap, 0).sum()):
                raise MemoryError("all_to_all capacity exceeded: the owner "
                                  "plan's segments disagree with the rows")
            buf = torch.empty((D, cap, C), dtype=torch.int32, device=dev)
            for o in range(D):
                lo, n = int(starts[o]), int(n_per_owner[o])
                for c, col in enumerate(rows):
                    buf[o, :n, c] = col[lo:lo + n]
            send.append(buf)
            n_rows.append(n_per_owner)
        del sorted_rows
        outs, recv_rows = ragged_all_to_all(send, n_rows)
        del send
        self.exchange_bytes = int(2 * 4 * C * recv_rows.sum())
        received = []
        for r, out in enumerate(outs):
            rows = torch.cat([out[j, :int(recv_rows[r, j])]
                              for j in range(D)])
            cols = [rows[:, c].contiguous() for c in range(C)]
            received.append((cols[:self.n_cols],
                             cols[self.n_cols] if has_counts else None))
        self.timings["exchange_groupsort_s"] = time.perf_counter() - t0
        return received, bounds

    def _owner_keys(self, bounds, o: int):
        """The column-0 values [lo, hi) of owner o's bins (None:
        unbounded)."""
        if bounds is None:
            return None, None
        shift = 2 * self.r0 if self.fuse else 0
        lo = int(bounds[o]) << shift if o > 0 else None
        hi = int(bounds[o + 1]) << shift if o < self.D - 1 else None
        return lo, hi

    def _owner_groups(self, emit):
        """Exchange, then per owner the grouping sort and, when the store
        spilled, the merge with the spilled rows of its bins.  emit(reps,
        totals) takes each owner's groups in (bin, k-mer) order, owner
        after owner: key columns and int64 totals, the u32 group totals
        (a group that wraps to 0 dropped) or, after spills, their exact
        sums with the spilled rows clamped at 0xFFFFFFFF, as kmc_tpu's
        finalize_packed and finalize take them.  Returns (n_total,
        n_super_kmers).  The store is consumed."""
        n_total = self.total_occurrences()
        n_skm = self.total_super_kmers()
        received, bounds = self._received_rows()
        t0 = time.perf_counter()
        grouped = [_group_reduce(cols, counts, self.n_cols)
                   for cols, counts in received]
        del received
        _sync(self.devices)
        self.timings["exchange_groupsort_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        spilled = [run for spill in self.spilled for run in spill]
        self.spilled = []
        launches = radix_sort_columns.launches
        for o in range(self.D):
            reps, totals = grouped[o]
            grouped[o] = None
            if not spilled:
                emit(reps, totals)
                continue
            lo, hi = self._owner_keys(bounds, o)
            merge_runs([(reps, u32_to_i32(totals))] + spilled, self.n_cols,
                       self.devices[o],
                       lambda r, t: emit(r, t.clamp_(max=0xFFFFFFFF)),
                       lo=lo, hi=hi)
            del reps, totals
        del spilled
        _sync(self.devices)
        self.merge_launches += radix_sort_columns.launches - launches
        self.timings["finalize_exec_s"] = time.perf_counter() - t0
        return n_total, n_skm

    def finalize_records(self, *, cutoff_min: int, cutoff_max: int,
                         counter_max: int, lut_prefix_len: int,
                         counter_size: int):
        """The owners' groups (_owner_groups) through the completer.
        Returns (rec u8[N, record_bytes] in (bin, k-mer) order,
        cutoff-filtered; lut uint64[n_used_bins << 2*lpl]; (n_unique,
        n_below, n_above); n_total; n_super_kmers).  The store is
        consumed."""
        parts = []

        def complete(reps, totals):
            bins, wr = _split_bins(reps, fuse=self.fuse, r0=self.r0)
            parts.append(_completer(
                bins, wr, totals, cutoff_min=cutoff_min,
                cutoff_max=cutoff_max, counter_max=counter_max, k=self.k,
                lut_prefix_len=lut_prefix_len, counter_size=counter_size,
                n_bins=self.n_used_bins))

        n_total, n_skm = self._owner_groups(complete)
        t0 = time.perf_counter()
        recs, lut, stats = [], None, np.zeros(3, np.int64)
        for rec, lut_o, stats_o in parts:
            recs.append(rec.cpu().numpy())
            lut_h = lut_o.cpu().numpy().astype(np.uint64)
            lut = lut_h if lut is None else lut + lut_h
            stats += torch.stack(stats_o).cpu().numpy()
        self.timings["finalize_d2h_s"] = time.perf_counter() - t0
        rec = np.concatenate(recs) if len(recs) > 1 else recs[0]
        return (rec, lut, tuple(int(x) for x in stats), n_total, n_skm)

    def finalize(self, *, cutoff_min: int, cutoff_max: int,
                 counter_max: int):
        """Words-path finalize (KFF output; kmc_tpu's finalize_packed
        without spills, finalize after them): the owners' groups
        (_owner_groups), cutoff-filtered and clamped to counter_max.
        Returns (bins int32, words uint32[N, W], counts uint32, (n_unique,
        n_below, n_above), n_total, n_super_kmers), host arrays in (bin,
        k-mer) order.  The store is consumed."""
        parts = []

        def collect(reps, totals):
            bins, wr = _split_bins(reps, fuse=self.fuse, r0=self.r0)
            keep, stats = _cutoffs(bins, totals, cutoff_min=cutoff_min,
                                   cutoff_max=cutoff_max,
                                   n_bins=self.n_used_bins)
            parts.append((
                bins[keep].to(torch.int32),
                torch.stack([u32_to_i32(w[keep]) for w in wr], dim=1),
                u32_to_i32(torch.clamp(totals[keep], max=counter_max)),
                torch.stack(stats)))

        n_total, n_skm = self._owner_groups(collect)
        t0 = time.perf_counter()
        bins = [np.zeros(0, np.int32)]
        words = [np.zeros((0, self.W), np.uint32)]
        counts = [np.zeros(0, np.uint32)]
        stats = np.zeros(3, np.int64)
        for b, w, c, st in parts:
            bins.append(b.cpu().numpy())
            words.append(_host_u32(w))
            counts.append(_host_u32(c))
            stats += st.cpu().numpy()
        self.timings["finalize_d2h_s"] = time.perf_counter() - t0
        return (np.concatenate(bins), np.concatenate(words),
                np.concatenate(counts), tuple(int(x) for x in stats),
                n_total, n_skm)


def _process_chunk_gen(input_files, fmt, state, *, shard_input,
                       n_parse_threads, min_shard_bytes):
    """The input's code-chunk stream (mirrors kmc_tpu's _process_chunk_gen
    for one process): for text formats one record-aligned shard list read
    by N parser threads, or the serial stream when not shard_input; BAM
    and KMC-database files are read whole, as kmc_tpu reads them (both
    strands of every BAM record, whatever both_strands says)."""
    from ..io.readers import (file_code_stream, process_input_shards,
                              shard_code_stream)

    if not shard_input:
        return file_code_stream(input_files, fmt, state)
    n_th = n_parse_threads or n_cpus()
    if fmt == "bam":
        from ..runner import bam_chunks

        return bam_chunks(input_files, state, both_strands=True,
                          n_threads=n_th)
    if fmt == "kmc":
        from ..runner import kmc_db_code_chunks

        return kmc_db_code_chunks(input_files, state)
    parts = process_input_shards(input_files, fmt, 1,
                                 min_shard_bytes=min_shard_bytes)
    return shard_code_stream(parts[0], fmt, state, n_threads=n_th)


def _groups(batches, D: int):
    """Pack batches and yield them in groups of up to D, one per shard in
    deal order: ("b", buf, tail_start) in the boundary-delta feed when the
    batch's sentinels are sparse, else ("m", buf) packed+mask (the
    single-device runner's choice, made per batch)."""
    from ..io.native import pack_codes_boundaries, pack_codes_fused

    group = []
    for batch in batches:
        buf, ts = pack_codes_boundaries(batch)
        group.append(("b", buf, ts) if buf is not None
                     else ("m", pack_codes_fused(batch)))
        if len(group) == D:
            yield group
            group = []
    if group:
        yield group


def _prefetch_groups(gen, depth: int = 2):
    """Producer thread for the ingest loop (mirrors kmc_tpu's
    _prefetch_groups): parse and pack of group g+1 overlap the upload and
    ingest of group g."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def run():
        try:
            for item in gen:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            err.append(e)
        finally:
            # the end-of-stream sentinel must land (a dropped one hangs the
            # consumer); block for space unless the consumer is gone
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=run, daemon=True, name="kmc-ingest-feed")
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # consumer gone mid-stream: release the producer
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)


def _check_ported():
    """Raise NotImplementedError for what the port does not count yet."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process counting over torch.distributed is ROADMAP A11c")


def _code_chunks(input_files, fmt, state, *, shard_input, n_parse_threads,
                 min_shard_bytes, homopolymer_compressed):
    """The code-chunk stream that the count ingests (_process_chunk_gen,
    then -hc's run collapse)."""
    gen = _process_chunk_gen(input_files, fmt, state,
                             shard_input=shard_input,
                             n_parse_threads=n_parse_threads,
                             min_shard_bytes=min_shard_bytes)
    if homopolymer_compressed:
        gen = homopolymer_compress_stream(gen)
    return gen


def _estimator_wrap(gen, est):
    """Feed each chunk to the ntCard sketch on its way to the count."""
    for chunk in gen:
        est.process_codes(chunk)
        yield chunk


def _merge_estimator_multihost(est):
    """The sketches' merge across processes (kmc_tpu's
    _merge_estimator_multihost: counter increments commute, so the merged
    sketch is their sum).  One process holds the only sketch: the
    identity, until multi-process runs (ROADMAP A11c)."""
    return est


def _stage0_greedy_map(input_files, fmt, *, k, sig_len, n_bins,
                       batch_positions, homopolymer_compressed, device,
                       timings):
    """The sampled signature histogram -> KMC's greedy balanced map
    (mirrors kmc_tpu's _stage0_greedy_map): the serial stream's first
    STATS_SAMPLE_BYTES of input in batches of batch_positions, each
    batch's signatures from the splitter-scan kernel added on `device`
    (ops/sortcount.py::stage0_accum).  Adds "stage0_s" and "map_build_s"
    to timings."""
    from ..io.readers import BatchStream, ParseState, file_code_stream
    from ..ops.sortcount import stage0_accum
    from ..signatures import build_signature_map, map_size

    t0 = time.perf_counter()
    s = batch_positions
    hist = torch.zeros(map_size(sig_len), dtype=torch.int64, device=device)
    gen = file_code_stream(input_files, fmt, ParseState(),
                           max_bytes=STATS_SAMPLE_BYTES)
    if homopolymer_compressed:
        gen = homopolymer_compress_stream(gen)
    for batch in BatchStream(s, k).batches(gen):
        stage0_accum(torch.from_numpy(batch).to(device), hist, s=s, k=k,
                     sig_len=sig_len)
    hist = hist.cpu().numpy().astype(np.uint64)
    t1 = time.perf_counter()
    sig_map = build_signature_map(hist, sig_len, n_bins)
    timings["stage0_s"] = t1 - t0
    timings["map_build_s"] = time.perf_counter() - t1
    return sig_map


def _fused_groups(batches, D: int):
    """Batches in the packed+mask feed, in groups of up to D (one per
    shard, in deal order)."""
    from ..io.native import pack_codes_fused

    group = []
    for batch in batches:
        group.append(pack_codes_fused(batch))
        if len(group) == D:
            yield group
            group = []
    if group:
        yield group


def _distributed_smallk(input_files, output_file_name, *, k, devices,
                        cutoff_min, cutoff_max, counter_max, both_strands,
                        batch_positions, input_file_type, output_type,
                        shard_input, n_parse_threads, min_shard_bytes,
                        homopolymer_compressed):
    """Small k (k <= 13) over shards (mirrors kmc_tpu's
    _distributed_smallk): each shard adds the batches dealt to it into a
    dense 4^k + 1 histogram on its own device (ops/smallk.py); the
    histograms are summed on the first shard's device, mod 2^32 as
    kmc_tpu's u32 sum wraps, and written as KMC1 or one KFF section."""
    from ..io.readers import BatchStream, ParseState
    from ..ops.smallk import smallk_batch, smallk_histogram_size
    from ..runner import smallk_finalize_and_write

    s = batch_positions
    hists = [torch.zeros(smallk_histogram_size(k), dtype=torch.int64,
                         device=dev) for dev in devices]
    state = ParseState()
    gen = _code_chunks(input_files, input_file_type, state,
                       shard_input=shard_input,
                       n_parse_threads=n_parse_threads,
                       min_shard_bytes=min_shard_bytes,
                       homopolymer_compressed=homopolymer_compressed)
    for group in _prefetch_groups(_fused_groups(
            BatchStream(s, k).batches(gen), len(devices))):
        for buf, hist in zip(group, hists):
            smallk_batch(torch.from_numpy(buf).to(hist.device), hist, s=s,
                         k=k, both_strands=both_strands)
    total = hists[0]
    for hist in hists[1:]:
        total += hist.to(total.device)
    del hists
    total = total.bitwise_and_(0xFFFFFFFF)[:-1]
    n_unique, n_below, n_above, n_total = smallk_finalize_and_write(
        total, k, cutoff_min=cutoff_min, cutoff_max=cutoff_max,
        counter_max=counter_max, canonical=both_strands,
        output_file_name=output_file_name, output_kff=output_type == "kff")
    return {
        "n_unique": n_unique,
        "n_below": n_below,
        "n_above": n_above,
        "n_total": n_total,
        "n_super_kmers": 0,  # small k bins nothing: no super-k-mers
        "n_reads": state.n_reads,
        "n_reads_local": state.n_reads,
        "consumed_bytes_local": state.consumed_bytes,
        "n_devices": len(devices),
        "n_processes": 1,
        "was_small_k_opt_used": True,
    }


def distributed_count(
    input_files,
    output_file_name: str,
    *,
    k: int,
    devices=None,
    sig_len: int = 9,
    n_bins: int = 512,
    cutoff_min: int = 2,
    cutoff_max: int = 10**9,
    counter_max: int = 255,
    both_strands: bool = True,
    batch_positions: int = 1 << 16,
    capacity_rows_per_device: int | None = 1 << 22,
    input_file_type: str = "fastq",
    output_type: str = "kmc",
    shard_input: bool = True,
    n_parse_threads: int | None = None,
    min_shard_bytes: int = 32 << 20,
    homopolymer_compressed: bool = False,
    signature_map_policy: str = "prefix",
    strict_memory_mode: bool = False,
    estimate_only: bool = False,
    opt_out_size: bool = False,
    max_ram_gb: int = 12,
):
    """Count with the store split into shards, one per entry of `devices`
    (default: every visible card; raises without one), and write the
    database kmc_tpu's distributed_count writes, byte for byte, with its
    stats dict; KMC2 output is also the single-device count's.

    capacity_rows_per_device: rows of each shard; None derives them from
    max_ram_gb like the single-device runner.  strict_memory_mode halves
    them.  Shards that overflow spill to host RAM under max_ram_gb's spill
    budget (MemoryError naming -m past it); "n_spills", "n_remerges" and
    "merge_launches" (grouping-sort launches of the merges of spilled
    runs) report it, and with spills the "finalize_exec_s" timing holds
    the owners' merges.  The modes are kmc_tpu's: k <= 13 counts small k
    (KMC1, or KFF), signature_map_policy="greedy" the sampled greedy map
    (its stage-0 and map-build seconds in "timings"), output_type="kff"
    writes out_db.kff, estimate_only (-e) returns "estimated_histogram"
    and "n_reads" and writes nothing, opt_out_size picks the LUT width
    from the estimate (and returns it too).  Multi-process runs raise
    NotImplementedError (ROADMAP A11c).  input_file_type takes "fastq",
    "fasta", "multifasta", "bam" and "kmc" (-fkmc: database prefixes)."""
    from ..formats.kmc_db import DbInfo, Kmc2DbWriter, pick_lut_prefix_len
    from ..io.readers import BatchStream, ParseState
    from ..memory import plan_memory

    if not (1 <= k <= MAX_K):
        raise ValueError(f"k must be in [1,{MAX_K}]")
    _check_ported()
    devices = resolve_devices(devices)
    D = len(devices)
    s = batch_positions
    stream = dict(shard_input=shard_input, n_parse_threads=n_parse_threads,
                  min_shard_bytes=min_shard_bytes,
                  homopolymer_compressed=homopolymer_compressed)

    if k < MIN_DEVICE_K and not estimate_only:
        # small k, like KMC when k < signature_len
        return _distributed_smallk(
            input_files, output_file_name, k=k, devices=devices,
            cutoff_min=cutoff_min, cutoff_max=cutoff_max,
            counter_max=counter_max, both_strands=both_strands,
            batch_positions=s, input_file_type=input_file_type,
            output_type=output_type, **stream)

    est = None
    if estimate_only or opt_out_size:
        from pathlib import Path

        from ..ops.nthash import NtCardEstimator

        # the sampling width by input size, as kmc_tpu picks it
        predicted = sum(Path(p).stat().st_size for p in input_files
                        if Path(p).exists())
        est = NtCardEstimator(k, s=7 if predicted < 50_000_000_000 else 11,
                              device=devices[0])

    state = ParseState()
    if estimate_only:
        for chunk in _code_chunks(input_files, input_file_type, state,
                                  **stream):
            est.process_codes(chunk)
        _merge_estimator_multihost(est)
        return {
            "estimated_histogram": est.estimate_histogram(),
            "n_reads": state.n_reads,
            "n_reads_local": state.n_reads,
            "consumed_bytes_local": state.consumed_bytes,
            "n_devices": D,
            "n_processes": 1,
        }

    timings = {}
    sig_map = None
    if signature_map_policy == "greedy":
        sig_map = _stage0_greedy_map(
            input_files, input_file_type, k=k, sig_len=sig_len,
            n_bins=n_bins, batch_positions=s,
            homopolymer_compressed=homopolymer_compressed,
            device=devices[0], timings=timings)

    # the -m carve sizes the shards and the spill budget; as in kmc_tpu,
    # the parse keeps the chunk size in force (the sketch of
    # --opt-out-size depends on it)
    plan = plan_memory(max_ram_gb, k=k, batch_positions=s,
                       n_threads=n_parse_threads or n_cpus(),
                       strict_memory=strict_memory_mode,
                       requested_rows=capacity_rows_per_device)
    capacity = max(plan.device_store_rows, 2 * s)
    # a card holds each shard whole from the start; on the CPU (tests) the
    # shards start small and grow
    on_card = all(d.type == "cuda" for d in devices)
    store = ShardedKmerStore(devices, capacity, k=k, sig_len=sig_len,
                             both_strands=both_strands, n_bins=n_bins,
                             initial_rows=None if on_card else 2 * s,
                             map_mode=signature_map_policy, sig_map=sig_map,
                             spill_budget_bytes=plan.spill_budget_bytes)
    bs = BatchStream(s, k)

    t_ingest0 = time.perf_counter()
    gen = _code_chunks(input_files, input_file_type, state, **stream)
    if est is not None:
        gen = _estimator_wrap(gen, est)
    for items in _prefetch_groups(_groups(bs.batches(gen), D)):
        store.ingest_group(items, s=s)
    _sync(devices)
    t_finalize0 = time.perf_counter()

    n_used_bins = store.n_used_bins
    counter_size = calc_counter_size(cutoff_max, counter_max)
    # the LUT width is picked before finalize from the single-device
    # runner's inputs: the estimated unique k-mers within the cutoffs
    # under -e / --opt-out-size (kmc.h:1436-1447), else 4 x n_reads, so the
    # database is the same bytes
    estimated_histogram = None
    if est is not None:
        _merge_estimator_multihost(est)
        estimated_histogram = est.estimate_histogram()
        del est
        end = min(cutoff_max + 1, len(estimated_histogram))
        n_est_unique = sum(estimated_histogram[cutoff_min:end])
    else:
        n_est_unique = 4 * state.n_reads
    lut_prefix_len = pick_lut_prefix_len(k, n_used_bins,
                                         max(n_est_unique, 1))
    if output_type == "kff":
        bins, words, counts, (n_unique, n_below, n_above), n_total, n_skm = (
            store.finalize(cutoff_min=cutoff_min, cutoff_max=cutoff_max,
                           counter_max=counter_max))
    else:
        rec, lut, (n_unique, n_below, n_above), n_total, n_skm = (
            store.finalize_records(
                cutoff_min=cutoff_min, cutoff_max=cutoff_max,
                counter_max=counter_max, lut_prefix_len=lut_prefix_len,
                counter_size=counter_size))
    timings.update(store.timings)
    timings["ingest_wall_s"] = t_finalize0 - t_ingest0
    timings["finalize_wall_s"] = time.perf_counter() - t_finalize0

    if output_type == "kff":
        from ..formats.kff import KffWriter
        from ..runner import write_kff_sections

        write_kff_sections(
            KffWriter(output_file_name + ".kff", canonical=both_strands, k=k,
                      counter_size=counter_size, min_count=cutoff_min,
                      max_count=cutoff_max),
            bins, words, counts, k=k, n_bins=n_used_bins)
    else:
        info = DbInfo(kmer_len=k, counter_size=counter_size,
                      lut_prefix_len=lut_prefix_len, signature_len=sig_len,
                      cutoff_min=cutoff_min, cutoff_max=cutoff_max,
                      both_strands=both_strands, n_bins=n_used_bins)
        writer = Kmc2DbWriter(output_file_name, info, store.host_sig_map())
        writer.n_unique = n_unique
        writer.n_below_min = n_below
        writer.n_above_max = n_above
        writer.n_total = n_total
        writer.write_all_records(rec, lut)
        writer.close()
    out = {
        "n_unique": n_unique,
        "n_below": n_below,
        "n_above": n_above,
        "n_total": n_total,
        "n_super_kmers": n_skm,
        "n_reads": state.n_reads,
        "n_reads_local": state.n_reads,
        "consumed_bytes_local": state.consumed_bytes,
        "n_devices": D,
        "n_processes": 1,
        "n_compactions": store.n_compactions,
        "n_spills": store.n_spills,
        "n_remerges": store.n_remerges,
        "merge_launches": store.merge_launches,
        "exchange_bytes": store.exchange_bytes,
        "timings": timings,
    }
    if estimated_histogram is not None:
        out["estimated_histogram"] = estimated_histogram
    return out
