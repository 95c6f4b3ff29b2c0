"""Multi-device counting: kmc_tpu/parallel/multihost.py's distributed_count on torch.

A process drives its shards of the store, each a DeviceKmerStore
(ops/store.py) on its own device; a device may hold several shards.  One
process may drive every shard (D below), or several processes theirs
(the last paragraph).

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

Several processes (a torch.distributed group, parallel/distributed.py's
init_multihost; kmc_tpu's multi-host run): each process drives its own
devices' shards, and the global shard list is the ranks' lists
concatenated rank-major.  With shard_input each process parses a disjoint
record-aligned byte range of the input (gz, BAM and -fkmc files whole, by
size midpoint), threads the super-k-mer carry through its own shards
only, and every process runs the same number of ingest groups: one flag
all-gather a group, a process that runs dry padding with all-invalid
batches, the feed (boundary-delta or packed+mask) chosen fleet-wide.
Without shard_input every process parses the whole stream and ingests
its own positions of each group of D batches; the carry of its first
shard is the previous batch's last signature, computed on the host.
Compactions and spills are fleet-wide decisions: the fullest shard is a
max over the group, and each spill's runs are gathered to every process,
so the budget, the re-merge and the MemoryError fall at the same spill on
every rank.  At finalize the per-sender bin edges are gathered so every
rank plans the same owners; the exchange moves the rows across processes
(exchange_kernel.py's ragged_all_to_all_processes: the same kernel, peer
processes' buffers opened through CUDA IPC; all_to_all_single on CPU
shards); each owner reduces what it received, and rank 0 gathers the
records and writes the database.  Every rank returns the same global
stats.  Small k sums the histograms to rank 0; the sketches of -e and
--opt-out-size are summed across processes (kmc_tpu's exact COO merge).

Across several nodes (kmc_tpu's hosts) all of the above holds as it is:
the control plane (flags, maxima, the gathered spills and bin edges, the
histograms and sketches, the records rank 0 gathers) is gloo over TCP,
and the carry without shard_input is computed on each host.  The
exchange runs in two legs: rows whose owner shares the sender's node move
by the kernel over CUDA IPC as above, the others by NCCL point-to-point
straight into the owner's output (exchange_route "ipc_kernel+nccl"; CPU
shards "plain+p2p": an all-to-all over the node's gloo group, gloo
point-to-point between nodes).  Such a group puts each process's shards
on one card of its own (two processes on one card, or one process on two
cards, raise at the count's start on every rank: NCCL binds a rank to one
card).  Every node reads the input at the same path (with shard_input
each its byte ranges), and the database is written on rank 0's node.
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
from .distributed import Fleet, resolve_devices
from .exchange_kernel import (ragged_all_to_all, ragged_all_to_all_processes,
                              send_buffer)


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
                 spill_budget_bytes: int | None = None,
                 fleet: Fleet | None = None):
        """devices: this process's shards.  map_mode "prefix" or "greedy"
        (sig_map, from signatures.build_signature_map, required: every shard
        bins its batches through it as it ingests them, kmc_tpu's eager
        sharded greedy).  spill_budget_bytes: the -m plan's budget for
        spilled rows (None sets none).  fleet: the process group's layout
        (default: this process's, made here; a collective when a group is
        live)."""
        if map_mode == "greedy" and sig_map is None:
            raise ValueError("greedy map_mode requires sig_map")
        self.devices = resolve_devices(devices)
        self.fleet = fleet or Fleet(self.devices)
        self.D = self.fleet.D  # shards of the whole group
        self.positions = self.fleet.positions  # this process's, in order
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
        # "kernel", "ipc_kernel" or "plain"; across nodes "ipc_kernel+nccl"
        # or "plain+p2p"
        self.exchange_route = None
        # host-side spilled rows: per spill, each shard's sorted run
        # (uint32 key columns tuple, uint32 counts)
        self.spilled: list[list] = []
        self.spill_budget_bytes = spill_budget_bytes
        self.n_spills = 0
        self.n_remerges = 0
        self.merge_launches = 0  # grouping-sort launches of the merges
        self._owner_merge_launches = 0  # of them, this process's owners'
        self.timings: dict[str, float] = dict(spill_s=0.0, remerge_s=0.0)

    # -- ingest --

    def ingest_group(self, items, *, s: int, carry=None):
        """Ingest one group: items[d] is this process's shard d's packed
        batch, ("b", buf, tail_start) in the boundary-delta feed or ("m",
        buf) in the packed+mask feed; a last group may hold fewer.  Every
        process of a group calls it once a group (compaction and spill are
        fleet-wide).  carry (int32[1]), when given, is the signature before
        the first shard's batch (a multi-process count without sharded
        input: the previous batch was another process's)."""
        if self._rows_per_device + s > self.cap:
            self.compact()
            if self._rows_per_device + s > self.cap:
                self.spill()
        if carry is not None:
            self._carry = carry
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
        self._rows_per_device = self.fleet.allmax(
            max(sh.n_used for sh in self.shards))

    # -- spill to host RAM under the -m budget --

    def spill(self):
        """Move every shard's live rows to host RAM, each shard's as one run
        sorted by its key columns, and start every shard empty (mirrors
        kmc_tpu's spill, which pulls the live rows as they stand: no
        compaction first); then hold the runs to the budget.  The runs of
        every process are gathered to every process in global shard order
        (kmc_tpu's _pull_rows all-gathers them), so the spilled set, its
        budget and its re-merges are the same on every rank."""
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
        if self.fleet.multi:
            runs = [run for part in self.fleet.all_gather_obj(runs)
                    for run in part]
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
        """This process's shards' occurrences."""
        return sum(sh.total_occurrences() for sh in self.shards)

    def total_super_kmers(self) -> int:
        """This process's shards' super-k-mers."""
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
        """Exchange: returns (per owner of this process (key columns, counts
        or None) of the rows it owns, from every shard of the group; the
        owners' bin bounds, None for one owner)."""
        D = self.D
        multi = self.fleet.multi
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
        # edges[j, b]: sender j's first row of bin b or a later one, for
        # every sender of the group (each process plans the same owners)
        local_edges = np.stack([e.cpu().numpy() for e in edges])
        edges = self.fleet.all_rows(local_edges)
        cap, bounds = self._owner_plan(np.diff(edges, axis=1))
        self.timings["owner_hist_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        C = self.n_cols + int(has_counts)
        counts = np.diff(edges[:, bounds], axis=1)  # n[j][o], every sender
        if int(np.maximum(counts - cap, 0).sum()):
            raise MemoryError("all_to_all capacity exceeded: the owner "
                              "plan's segments disagree with the rows")
        send = []
        for rows, starts, dev in zip(sorted_rows, local_edges[:, bounds],
                                     self.devices):
            buf = send_buffer((D, cap, C), dev, multi)
            for o in range(D):
                lo, n = int(starts[o]), int(starts[o + 1] - starts[o])
                for c, col in enumerate(rows):
                    buf[o, :n, c] = col[lo:lo + n]
            send.append(buf)
        del sorted_rows
        if multi:
            outs, recv_rows = ragged_all_to_all_processes(
                send, counts, self.fleet.layout)
            route = "plain" if self.devices[0].type == "cpu" else "ipc_kernel"
            if self.fleet.multi_node:
                route += "+p2p" if route == "plain" else "+nccl"
        else:
            outs, recv_rows = ragged_all_to_all(send, counts)
            route = "plain" if self.devices[0].type == "cpu" else "kernel"
        del send
        self.exchange_route = route
        self.exchange_bytes = int(2 * 4 * C * counts.sum())
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
        """Exchange, then per owner of this process the grouping sort and,
        when the store spilled, the merge with the spilled rows of its
        bins.  emit(reps, totals) takes each owner's groups in (bin, k-mer)
        order, owner after owner: key columns and int64 totals, the u32
        group totals (a group that wraps to 0 dropped) or, after spills,
        their exact sums with the spilled rows clamped at 0xFFFFFFFF, as
        kmc_tpu's finalize_packed and finalize take them.  Returns this
        process's (n_total, n_super_kmers).  The store is consumed."""
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
        for l, o in enumerate(self.positions):
            reps, totals = grouped[l]
            grouped[l] = None
            if not spilled:
                emit(reps, totals)
                continue
            lo, hi = self._owner_keys(bounds, o)
            merge_runs([(reps, u32_to_i32(totals))] + spilled, self.n_cols,
                       self.devices[l],
                       lambda r, t: emit(r, t.clamp_(max=0xFFFFFFFF)),
                       lo=lo, hi=hi)
            del reps, totals
        del spilled
        _sync(self.devices)
        self._owner_merge_launches = radix_sort_columns.launches - launches
        self.merge_launches += self._owner_merge_launches
        self.timings["finalize_exec_s"] = time.perf_counter() - t0
        return n_total, n_skm

    def _global(self, n_total, n_skm, stats):
        """The group's (n_total, n_super_kmers, stats) from this process's,
        and the merges' launches of every owner added in."""
        sums = self.fleet.allsum([n_total, n_skm, *stats,
                                  self._owner_merge_launches])
        self.merge_launches += sums[-1] - self._owner_merge_launches
        return sums[0], sums[1], tuple(sums[2:-1])

    def finalize_records(self, *, cutoff_min: int, cutoff_max: int,
                         counter_max: int, lut_prefix_len: int,
                         counter_size: int):
        """The owners' groups (_owner_groups) through the completer.
        Returns (rec u8[N, record_bytes] in (bin, k-mer) order,
        cutoff-filtered; lut uint64[n_used_bins << 2*lpl]; (n_unique,
        n_below, n_above); n_total; n_super_kmers), the counts the whole
        group's; in a process group rank 0 gathers rec and lut, and the
        other ranks get None for both.  The store is consumed."""
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
        del parts
        n_total, n_skm, stats = self._global(n_total, n_skm, stats)
        if self.fleet.multi:
            # the owners are rank-major: rank 0 concatenates in rank order
            got = self.fleet.gather_obj((recs, lut))
            if got is None:
                recs, lut = [None], None
            else:
                # an owner whose bins hold no row emits nothing
                recs = [r for part, _ in got for r in part]
                luts = [lut_p for _, lut_p in got if lut_p is not None]
                lut = sum(luts[1:], luts[0]) if luts else None
        self.timings["finalize_d2h_s"] = time.perf_counter() - t0
        rec = np.concatenate(recs) if len(recs) > 1 else recs[0]
        return (rec, lut, stats, n_total, n_skm)

    def finalize(self, *, cutoff_min: int, cutoff_max: int,
                 counter_max: int):
        """Words-path finalize (KFF output; kmc_tpu's finalize_packed
        without spills, finalize after them): the owners' groups
        (_owner_groups), cutoff-filtered and clamped to counter_max.
        Returns (bins int32, words uint32[N, W], counts uint32, (n_unique,
        n_below, n_above), n_total, n_super_kmers), host arrays in (bin,
        k-mer) order, the counts the whole group's; in a process group
        rank 0 gathers the arrays, the other ranks get None for them.  The
        store is consumed."""
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
        del parts
        n_total, n_skm, stats = self._global(n_total, n_skm, stats)
        out = [np.concatenate(bins), np.concatenate(words),
               np.concatenate(counts)]
        if self.fleet.multi:
            got = self.fleet.gather_obj(out)
            out = [None] * 3 if got is None else [
                np.concatenate(cols) for cols in zip(*got)]
        self.timings["finalize_d2h_s"] = time.perf_counter() - t0
        return (*out, stats, n_total, n_skm)


def _process_chunk_gen(input_files, fmt, state, *, shard_input,
                       n_parse_threads, min_shard_bytes, fleet=None):
    """This process's code-chunk stream (mirrors kmc_tpu's
    _process_chunk_gen): for text formats its record-aligned part of the
    shard list (process_input_shards over the group's processes) read by N
    parser threads, or the whole serial stream when not shard_input; BAM
    and KMC-database files are read whole, each by the process whose share
    of the input's bytes holds the file's midpoint, as kmc_tpu reads them
    (both strands of every BAM record, whatever both_strands says)."""
    from ..io.readers import (file_code_stream, process_input_shards,
                              shard_code_stream)

    if not shard_input:
        return file_code_stream(input_files, fmt, state)
    n_procs, pid = (fleet.world, fleet.rank) if fleet else (1, 0)
    n_th = n_parse_threads or n_cpus()
    if fmt in ("bam", "kmc"):
        from pathlib import Path

        def size(p):
            if Path(p).exists():
                return Path(p).stat().st_size
            suf = Path(str(p) + ".kmc_suf")  # -fkmc takes a DB prefix
            return suf.stat().st_size if suf.exists() else 0

        sizes = [size(p) for p in input_files]
        total = sum(sizes) or 1
        mine, acc = [], 0
        for path, sz in zip(input_files, sizes):
            if min(int((acc + sz / 2) * n_procs / total), n_procs - 1) == pid:
                mine.append(path)
            acc += sz
        if fmt == "bam":
            from ..runner import bam_chunks

            return bam_chunks(mine, state, both_strands=True, n_threads=n_th)
        from ..runner import kmc_db_code_chunks

        return kmc_db_code_chunks(mine, state)
    parts = process_input_shards(input_files, fmt, n_procs,
                                 min_shard_bytes=min_shard_bytes)
    return shard_code_stream(parts[pid], fmt, state, n_threads=n_th)


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


def _local_groups(batches, n_local: int):
    """This process's batches in groups of up to n_local, each (batch, its
    boundary-delta pack (buf or None, tail_start)): the producer half of
    _lockstep_groups, which runs no collective."""
    from ..io.native import pack_codes_boundaries

    group = []
    for batch in batches:
        group.append((batch, pack_codes_boundaries(batch)))
        if len(group) == n_local:
            yield group
            group = []
    if group:
        yield group


def _lockstep_groups(local_groups, fleet, n_local: int, batch_bytes: int):
    """Groups of this process's batches (sharded input in a process
    group), every process yielding the same number (mirrors kmc_tpu's
    _lockstep_groups): one flag all-gather a group, on the calling thread;
    a process whose own stream has run dry pads its shards with
    all-invalid batches until every process has; a group takes the
    boundary-delta feed only when every batch of every process admits it,
    else the packed+mask feed.  local_groups yields _local_groups' groups."""
    from ..defs import CODE_INVALID
    from ..io.native import pack_codes_fused

    src = iter(local_groups)
    pad = None
    done = False
    try:
        while True:
            group = None if done else next(src, None)
            if group is None:
                done, group = True, []
            bounds_ok = (len(group) == n_local
                         and all(buf is not None for _, (buf, _) in group))
            flags = fleet.all_flags([bool(group), bounds_ok])
            if not flags[:, 0].any():
                return
            if flags[:, 1].all():
                yield [("b", buf, ts) for _, (buf, ts) in group]
                continue
            if pad is None and len(group) < n_local:
                pad = np.full(batch_bytes, CODE_INVALID, np.uint8)
            raw = [batch for batch, _ in group] + [pad] * (n_local - len(group))
            yield [("m", pack_codes_fused(batch)) for batch in raw]
    finally:
        close = getattr(src, "close", None)
        if close is not None:
            close()


def _last_signature(batch: np.ndarray, *, s: int, k: int, sig_len: int,
                    both_strands: bool) -> torch.Tensor:
    """The signature at a batch's last start position (int32[1]; the
    ingest's prev_sig after the batch), from the plain splitter scan of
    its last 8 positions on the host: a position's signature depends on
    its own window only."""
    from ..io.readers import batch_len
    from ..ops.extract_kernel import splitter_scan_plain

    w = 8
    codes = torch.from_numpy(np.ascontiguousarray(
        batch[s - w:s - w + batch_len(w, k)]))
    sig, _ = splitter_scan_plain(codes, s=w, k=k, sig_len=sig_len,
                                 both_strands=both_strands)
    return sig[-1:].clone()


def _serial_deal(batches, fleet, pack, carry_of=None):
    """Without sharded input in a process group: every process reads the
    whole stream, and of each group of D batches takes its own positions,
    packed by pack(batch).  Yields (items, carry): carry is
    carry_of(batch) of the batch before this process's first position (an
    other process's; None for the stream's first batch, or without
    carry_of)."""
    D, pos = fleet.D, fleet.positions
    prev_last = None  # the previous group's last batch

    def take(group):
        items = [pack(group[p]) for p in pos if p < len(group)]
        if not items or carry_of is None:
            return items, None
        before = group[pos[0] - 1] if pos[0] > 0 else prev_last
        return items, None if before is None else carry_of(before)

    group = []
    for batch in batches:
        group.append(batch)
        if len(group) == D:
            yield take(group)
            prev_last, group = group[-1], []
    if group:
        yield take(group)


def _pack_batch(batch):
    """One batch in the single-device runner's feed choice (see _groups)."""
    from ..io.native import pack_codes_boundaries, pack_codes_fused

    buf, ts = pack_codes_boundaries(batch)
    return ("b", buf, ts) if buf is not None else ("m",
                                                   pack_codes_fused(batch))


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


def _code_chunks(input_files, fmt, state, *, shard_input, n_parse_threads,
                 min_shard_bytes, homopolymer_compressed, fleet=None):
    """The code-chunk stream that this process ingests
    (_process_chunk_gen, then -hc's run collapse)."""
    gen = _process_chunk_gen(input_files, fmt, state,
                             shard_input=shard_input,
                             n_parse_threads=n_parse_threads,
                             min_shard_bytes=min_shard_bytes, fleet=fleet)
    if homopolymer_compressed:
        gen = homopolymer_compress_stream(gen)
    return gen


def _estimator_wrap(gen, est):
    """Feed each chunk to the ntCard sketch on its way to the count."""
    for chunk in gen:
        est.process_codes(chunk)
        yield chunk


def _merge_estimator_multihost(est, fleet):
    """The sketches' exact merge across processes (kmc_tpu's
    _merge_estimator_multihost): counter increments commute, so the merged
    sketch is their sum, u32 wrapping as kmc_tpu's; each counter crosses
    the group as COO (its nonzero slots and values: the sketches are
    sparse at sampling rate 2^-s).  One process (or fleet None): the
    identity."""
    if fleet is None or not fleet.multi:
        return est
    for ci, ctr in enumerate(est.counters):
        nz = torch.nonzero(ctr).squeeze(1)
        coo = (nz.cpu().numpy().astype(np.int64),
               ctr[nz].cpu().numpy().astype(np.int64))
        merged = np.zeros(ctr.shape[0], np.int64)
        for idx, val in fleet.all_gather_obj(coo):
            np.add.at(merged, idx, val & 0xFFFFFFFF)
        merged = (merged & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        est.counters[ci] = torch.from_numpy(merged).to(ctr.device)
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
                        homopolymer_compressed, fleet):
    """Small k (k <= 13) over shards (mirrors kmc_tpu's
    _distributed_smallk): each shard adds the batches dealt to it into a
    dense 4^k + 1 histogram on its own device (ops/smallk.py); the
    histograms are summed on the first shard's device, then over the
    processes of a group on rank 0, mod 2^32 as kmc_tpu's u32 sum wraps,
    and rank 0 writes them as KMC1 or one KFF section.  No collective runs
    while the shards count."""
    from ..io.native import pack_codes_fused
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
                       homopolymer_compressed=homopolymer_compressed,
                       fleet=fleet)
    batches = BatchStream(s, k).batches(gen)
    if fleet.multi and not shard_input:
        groups = (items for items, _ in _serial_deal(batches, fleet,
                                                     pack_codes_fused))
    else:
        groups = _fused_groups(batches, len(devices))
    for group in _prefetch_groups(groups):
        for buf, hist in zip(group, hists):
            smallk_batch(torch.from_numpy(buf).to(hist.device), hist, s=s,
                         k=k, both_strands=both_strands)
    total = hists[0]
    for hist in hists[1:]:
        total += hist.to(total.device)
    del hists
    if fleet.multi:
        host = fleet.sum_to_root(total.cpu())
        total = None if host is None else host.to(total.device)
        del host
    stats = None
    if total is not None:
        total = total.bitwise_and_(0xFFFFFFFF)[:-1]
        stats = smallk_finalize_and_write(
            total, k, cutoff_min=cutoff_min, cutoff_max=cutoff_max,
            counter_max=counter_max, canonical=both_strands,
            output_file_name=output_file_name,
            output_kff=output_type == "kff")
        del total
    n_unique, n_below, n_above, n_total = fleet.broadcast_obj(stats)
    return {
        "n_unique": n_unique,
        "n_below": n_below,
        "n_above": n_above,
        "n_total": n_total,
        "n_super_kmers": 0,  # small k bins nothing: no super-k-mers
        "n_reads": _n_reads(state, fleet, shard_input),
        "n_reads_local": state.n_reads,
        "consumed_bytes_local": state.consumed_bytes,
        "n_devices": fleet.D,
        "n_processes": fleet.world,
        "was_small_k_opt_used": True,
    }


def _n_reads(state, fleet, shard_input) -> int:
    """The input's reads: summed over the processes' shards, or this
    process's count when every process parsed the whole input."""
    if fleet.multi and shard_input:
        return fleet.allsum([state.n_reads])[0]
    return state.n_reads


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
    from the estimate (and returns it too).  input_file_type takes
    "fastq", "fasta", "multifasta", "bam" and "kmc" (-fkmc: database
    prefixes).

    In a torch.distributed group (init_multihost first) every process
    calls it with its own `devices`; the shards of all processes form one
    store (see the module docstring), rank 0 writes the database, and
    every rank returns the same stats but "n_reads_local",
    "consumed_bytes_local" and "timings" (this process's parse and
    clocks; "exchange_route" there names the exchange's route)."""
    from ..formats.kmc_db import DbInfo, Kmc2DbWriter, pick_lut_prefix_len
    from ..io.readers import BatchStream, ParseState
    from ..memory import plan_memory

    if not (1 <= k <= MAX_K):
        raise ValueError(f"k must be in [1,{MAX_K}]")
    devices = resolve_devices(devices)
    fleet = Fleet(devices)
    D = fleet.D
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
            output_type=output_type, fleet=fleet, **stream)

    est = None
    if estimate_only or opt_out_size:
        from pathlib import Path

        from ..ops.nthash import NtCardEstimator

        # the sampling width by input size, as kmc_tpu picks it
        predicted = sum(Path(p).stat().st_size for p in input_files
                        if Path(p).exists())
        est = NtCardEstimator(k, s=7 if predicted < 50_000_000_000 else 11,
                              device=devices[0])
    # every process's sketch hashed its own shard, and their sum is the
    # input's; without sharded input each already hashed all of it
    est_fleet = fleet if shard_input else None

    state = ParseState()
    if estimate_only:
        for chunk in _code_chunks(input_files, input_file_type, state,
                                  fleet=fleet, **stream):
            est.process_codes(chunk)
        _merge_estimator_multihost(est, est_fleet)
        return {
            "estimated_histogram": est.estimate_histogram(),
            "n_reads": _n_reads(state, fleet, shard_input),
            "n_reads_local": state.n_reads,
            "consumed_bytes_local": state.consumed_bytes,
            "n_devices": D,
            "n_processes": fleet.world,
        }

    timings = {}
    sig_map = None
    if signature_map_policy == "greedy":
        # every process samples the same start of the serial stream, so
        # every process builds the same map
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
                             spill_budget_bytes=plan.spill_budget_bytes,
                             fleet=fleet)
    bs = BatchStream(s, k)

    t_ingest0 = time.perf_counter()
    gen = _code_chunks(input_files, input_file_type, state, fleet=fleet,
                       **stream)
    if est is not None:
        gen = _estimator_wrap(gen, est)
    batches = bs.batches(gen)
    if not fleet.multi:
        groups = ((items, None) for items in _prefetch_groups(
            _groups(batches, D)))
    elif shard_input:
        groups = ((items, None) for items in _lockstep_groups(
            _prefetch_groups(_local_groups(batches, len(devices))), fleet,
            len(devices), bs.batch_bytes))
    else:
        groups = _prefetch_groups(_serial_deal(
            batches, fleet, _pack_batch, lambda batch: _last_signature(
                batch, s=s, k=k, sig_len=sig_len,
                both_strands=both_strands)))
    for items, carry in groups:
        store.ingest_group(items, s=s, carry=carry)
    _sync(devices)
    n_reads = _n_reads(state, fleet, shard_input)
    t_finalize0 = time.perf_counter()

    n_used_bins = store.n_used_bins
    counter_size = calc_counter_size(cutoff_max, counter_max)
    # the LUT width is picked before finalize from the single-device
    # runner's inputs: the estimated unique k-mers within the cutoffs
    # under -e / --opt-out-size (kmc.h:1436-1447), else 4 x n_reads, so the
    # database is the same bytes
    estimated_histogram = None
    if est is not None:
        _merge_estimator_multihost(est, est_fleet)
        estimated_histogram = est.estimate_histogram()
        del est
        end = min(cutoff_max + 1, len(estimated_histogram))
        n_est_unique = sum(estimated_histogram[cutoff_min:end])
    else:
        n_est_unique = 4 * n_reads
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
    if store.exchange_route is not None:
        timings["exchange_route"] = store.exchange_route

    if fleet.rank != 0:
        pass  # rank 0 writes the database
    elif output_type == "kff":
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
        "n_reads": n_reads,
        "n_reads_local": state.n_reads,
        "consumed_bytes_local": state.consumed_bytes,
        "n_devices": D,
        "n_processes": fleet.world,
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
