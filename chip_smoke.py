#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kmc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase (the contract's run)
    python3 chip_smoke.py 2 6        # phase 1, the phases named and those
                                     # whose results they take (PHASES)
    python3 chip_smoke.py 14         # the other routes (with phases 4, 5)
    python3 chip_smoke.py 15         # -fbam, -fkmc, the readers (4, 5)
    python3 chip_smoke.py 16 17      # kmc_tools and the greedy map (4, 5)
    python3 chip_smoke.py 18         # the sharded modes, the SPMD step (4, 5)
    python3 chip_smoke.py 19         # multi-process counting (4, 5, 7)
    python3 chip_smoke.py 20         # counting across nodes (4, 5, 7)

Phases (any failure exits non-zero):
  1. card facts (name, power limit) and the kernels' build, with ptxas's
     register / shared-memory report;
  2. the splitter-scan entry against its plain version at s = 2^22,
     m = 9, k in {27, 32, 33, 55, 129, 256}, both strands and forward only;
     the fused ingest (ops/ingest_kernel.py) against ingest_plain at
     s = 2^22, k in {14, 27, 32, 33, 55, 256}, both feeds, both strands and
     one, with and without a counts column, two batches from a non-aligned
     n_used with tail_start inside the first: every column, the counts,
     occ, skm and prev_sig equal; each timed beside its plain version and
     the parent's torch-op route (decode ops, the scan entry, binning ops),
     with its bound by bytes and, as a diagnostic, the time the design's
     own SASS instructions per position take; the fused ingest's greedy
     entry (a map from build_signature_map on a random histogram, m = 9
     and 11, k in {27, 33, 55}, both feeds, with and without the stage-0
     histogram output) and the prefix entry's histogram output, bit-exact
     against ingest_plain, each timed at k = 27 with its bound by bytes
     (the map's and the histogram's sectors that the batch touches);
     then one batch through DeviceKmerStore.ingest_boundaries /
     ingest_fused, device time and device items per batch;
  3. the grouping-sort (radix) kernel against its plain version at the
     main path's layouts: 2^26 rows x (2 keys + counts), an odd length x
     (3 keys + counts), 2^26 x (1 key + 2 payloads), 2^24 x (4 keys +
     counts), 2^22 x (17 keys + counts), dead rows included; each timed
     beside one torch.sort where one computes it, with the bytes the
     design moves, and per stage at 2^26 x (2 keys + counts);
  4. end to end on a mid-size synthetic FASTQ: the card's KMC2 database must
     equal the CPU's byte for byte, with several compactions;
  5. the full-size run: bench.py's workload (8 Mbp genome, 30x, 150 bp reads,
     seed 0), k = 27, -ci2, default -m 12, on the card; its peak device
     memory may not pass the grouping sort's 3,333,154,304 bytes;
  6. the same run under torch.profiler: device busy time against the wall
     (the idle share), the kernels that take the most device time, and
     the device time, items and host launches under the store's "ingest"
     and "compact" labels;
  7. the exchange kernel (ragged and dense all-to-all) against its plain
     version: 4 shards, segments of 2^24 rows, 2 and 3 words a row, one
     launch for the card; on a machine of several cards also each shard
     on its own card (one launch a card), timed on the host clock;
  8. the sharded count (distributed_count, 4 shards) on phase 4's FASTQ
     with small shards that compact: the card's database must equal the
     CPU's and phase 4's single-device one, byte for byte; then with shards
     of 2^19 rows that spill, whose runs the owners merge on their cards:
     the same three-way equality, and equal spills and re-merges;
  9. the sharded count at full size (phase 5's FASTQ and knobs, the -m 12
     plan per shard): its database must equal phase 5's byte for byte;
     then the same run under torch.profiler, as phase 6;
 10. the last two kernels: the 1-D splitter-scan entry (pallas_extract's
     contract) at s = 2^22, k in {21, 27, 33, 55}, both strands and one,
     bit-exact against its plain version; the three memory probes of
     `python -m kmc_tpu_torch.microbench_sort pallas` at N = 2^28, run
     through that section's entry, then each bit-exact against its plain
     version (which is also the library call they are timed against);
     then `python -m kmc_tpu_torch.microbench_sort sort`'s measurements
     at MB_LOGN = 26, and its roofline, bitonic, scatter and onehot
     sections (torch ops) at 2^26;
 11. the spilling count at mid size (phase 4's FASTQ): a store that spills
     and finalizes by replaying its runs, and a smaller one that finalizes
     by the host merge; each card DB must equal the CPU's and phase 4's;
     a stage-1 checkpoint saved on the card and resumed on the CPU, and
     the reverse, must write the same bytes;
 12. the spilling count at full size: bench.py's generator with a 2^27-bp
     genome (134 Mbp) at 10x, k = 27, -ci2, batches of 2^22, default
     -m 12 (2^26 store rows): about twice the store's rows in unique
     k-mers, so it spills, re-merges under the budget and finalizes by the
     host route, both merges on the card (their seconds, their radix-sort
     launches, the peak device memory and the host's peak RSS printed);
     n_total_kmers must be n_reads x 124 and its DB must equal a
     non-spilling card count's (device_store_rows = 2^28).  The count runs
     under torch.profiler for the device's spans only (no store labels, no
     all-threads host trace);
 13. the same input and knobs over 4 shards of 2^26 rows (on distinct
     cards where there are several): the shards spill and re-merge, the
     owners merge the spilled runs on their cards, n_total must be n_reads
     x 124 and the DB must equal phase 12's non-spilling DB byte for byte;
     wall, stage splits, spills, re-merges, merge seconds and each card's
     peak memory printed;
 14. the other routes of one device.  On phase 4's FASTQ, card against
     CPU, byte for byte and with equal results: KFF output (-okff), -w,
     small k (k = 13 and 9, KMC1; k = 13 KFF), the host buckets
     (--no-device-store, KMC2 and KFF), --opt-out-size, KFF through the
     replay and the host finalize routes (phase 11's stores), and -e
     through the CLI (its histogram file).  On phase 5's FASTQ, timed on
     the card: KFF (its records = phase 5's kept k-mers), -w, host-bucket
     KFF (its sorted (k-mer, count) set = the device store's KFF's) and
     --opt-out-size, each with phase 5's n_total, n_unique, n_below and
     n_above; small k at k = 13 (n_total = n_reads x 138); -e alone.  Each
     prints its wall and stage seconds, the launches of the fused ingest,
     the scan entry and the radix sort (each route must launch the kernels
     it uses: the store's routes the fused ingest, the host buckets the
     scan entry, both the sort) and its peak device memory;
 15. BAM and KMC-database input, and the database readers.  At mid size,
     card against CPU byte for byte: -fbam over a BGZF BAM of phase 4's
     reads (also == phase 4's DB), -fkmc from phase 4's DB at k = 27 and
     21, -fkmc from a KMC1 DB (k = 13 -> 9), and distributed_count over
     2 shards with -fbam (== phase 4's DB) and -fkmc (== the single-device
     -fkmc DB).  At full size, timed: -fbam over phase 5's reads (DB ==
     phase 5's, n_total = n_reads x 124), -fkmc from phase 5's DB at
     k = 21 (n_total = n_records x 7) and at k = 27 (each record once,
     the same k-mers; under torch.profiler: device busy and idle share);
     each with its host parse alone, its launches (every -fkmc launch
     takes the fused ingest's packed+mask entry, no -fbam launch does)
     and its peak device memory.  Then the readers on phase 5's DB:
     read_db, kmc_dump (native) == dump_db_file, OpenForListing over
     2 x 10^5 k-mers == sorted_records, and OpenForRA in memory and on
     disk: CheckKmer on 10^4 records and GetCountersForRead on 2 x 10^4
     reads == the records;
 16. kmc_tools (`python -m kmc_tpu_torch.tools_cli`, each operation in a
     process of its own): info, check, transform (histogram, dump -s,
     reduce -ci3, compact, set_counts), simple with all six operations in
     one pass (KMC1, then -okff), a complex file, compare A A and A B, and
     filter, on A = phase 5's DB and B = a count of the first quarter of
     phase 5's reads at its knobs (filter over 10^5 of its reads), each
     timed with its process's peak RSS; |A u B| + |A n B| = |A| + |B|,
     |A - B| = |A| - |A n B|, union counters = sums capped at 255,
     histogram total = |A|, and the NumPy route's union and histogram
     equal the native ones (the tools load no torch: their three routes
     are held against kmc_tpu byte for byte by the CPU tests);
 17. the greedy signature map of the device store.  At mid size (phase
     4's FASTQ), deferred and eager: card DB == CPU DB byte for byte,
     deferred == eager, the replay and host spill routes == the
     non-spilling DB, a deferred greedy checkpoint card -> CPU and CPU ->
     card == the straight count.  At full size (phase 5's FASTQ and
     knobs), deferred and eager, timed, with the peak device memory:
     n_total = n_reads x 124, the (k-mer, count) set == phase 5's, the
     .kmc_pre footer holds the greedy map; deferred launches every batch
     on the prefix entry, the first 2^27 / 2^22 = 32 with the histogram,
     and the collect's one radix sort, eager the scan entry's stage 0 and
     every batch on the greedy entry; then the deferred run under
     torch.profiler (device busy and idle share);
 18. the sharded count's other modes and the SPMD count step, 4 shards.
     At mid size (phase 4's FASTQ, phase 8's knobs): small k (k = 13,
     KMC1 and KFF), the greedy map (k = 27 and 32), KFF, -e and
     --opt-out-size, and greedy and KFF on shards that spill: the card's
     files and stats == the CPU shards', byte for byte; greedy and KFF
     at k = 27 hold phase 4's (k-mer, count) set.  At full size (phase
     5's FASTQ and knobs), timed with each card's peak memory and each
     mode's launches (the greedy map on the greedy entry for every batch,
     its stage 0 on the scan entry): greedy, KFF and --opt-out-size hold
     phase 5's (k-mer, count) set and n_total, k = 13's DB == the
     single-device small-k DB, -e estimates.  Then
     make_distributed_count_step over phase 5's batches in rounds of 4:
     every round bit-exact against the same step on the plain versions
     of its kernels, the summed counts == phase 5's n_total, device time
     a round from torch.profiler, the launches of the dense all-to-all,
     the radix sort and the scan entry;
 19. multi-process counting (tests/torch_multiproc_worker.py: processes
     of one torch.distributed gloo group, two on card 0 with two shards
     each, or four with one card each on a machine of four cards; four
     shards in all).  At mid size (phase 4's FASTQ, phase 8's knobs, every
     process reading the whole stream): the default count, k = 13, KFF,
     -e, the greedy map and a spilling count that re-merges under a spill
     budget, each == the single-process count over 4 card shards, every
     file byte for byte and every global stat, each store route launching
     the fused ingest, the sort and the exchange kernel across processes
     (one launch a card, by the lowest rank on it, the other processes'
     buffers opened through CUDA IPC).
     At full size (phase 5's FASTQ and knobs, the processes parsing
     disjoint byte ranges, shards of 2^26 rows): DB == phase 5's,
     n_total and n_super_kmers == phase 5's, each rank's wall, stage
     seconds, peak device memory and the exchange kernel's time against
     its bytes' bound and the launch skew between the processes.  Then
     the cross-process exchange alone at phase 7's shapes, bit-exact and
     timed beside phase 7's in-process figure, and NCCL's
     all_to_all_single of the same rows as its yardstick (four cards; on
     one card whether NCCL takes two ranks on one GPU);
 20. counting across nodes, emulated on one machine as two nodes of two
     processes (tests/torch_multiproc_worker.py's MP_NODE: ranks 0-1 and
     2-3), one card each on a machine of four or more cards: at mid size
     every mode of phase 19 == one process over the four cards, files and
     stats, the exchange in two legs (the kernel over CUDA IPC within a
     node, NCCL point-to-point between the nodes) with no IPC open of the
     other node's handles; at full size phase 5's input split by bytes,
     DB == phase 5's; then the exchange alone at phase 7's shapes,
     bit-exact, the on-node kernel's and the NCCL leg's device times each
     against its bound (NVLink's 450 GB/s for the NCCL leg: one machine,
     no InfiniBand figure), each node's span; then whether NCCL carries
     a process that holds two cards (the layout the port refuses across
     nodes).  On fewer than four cards the same emulation on CPU shards
     over phase 4's first 16,000 reads (every mode, and the input split by
     bytes, == one process); the NCCL leg is not run there.
Then a {"kernels": [...]} line with each kernel's launches on its path
(phase 9 for the sharded path's kernels, the fused ingest among them; the
dense all-to-all from phase 18's SPMD step; the 2-D scan entry from
phase 14's full-size host-bucket run, the 1-D entry and the probes from
their own entries in phase 10) and its times from phases 2, 3, 7 and 10.
The fused ingest's row also holds the greedy entry's and the histogram's
times from phase 2 and their launches in phase 17, and phase 18's
sharded greedy and KFF launches; the radix sort's row the collect's
launches in phase 17 and phase 18's; the scan entry's, the exchanges'
rows phase 18's too; the ragged exchange's row phase 7's time across
cards, phase 19's launches across processes (each rank's, in the
full-size count) and the times of the exchange across processes there
and at phase 7's shapes (host clock from the first launching process's
launch to the last one's synchronize; the launch skew beside them)
against their bytes' bounds, with NCCL's time for the same rows, and
phase 20's two legs across emulated nodes.  Every
device-store path must ingest through the fused kernel and never
through the scan entry.
Shards sit on distinct cards when the machine has two or more, else all
on card 0.  The last line is {"ok": true, "device": {...}}.
Imports neither jax nor kmc_tpu.  Times come from CUDA events around
repeated launches after a warm-up; bounds are the bytes each function
must move over the H100 SXM's 3.35 TB/s (the scan kernel's instruction
time at INSTR_PER_S is printed beside them, a diagnostic of its design).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import resource
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_chip_smoke_work"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way
M = 9


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over u32 values held in int32 bit views."""
    if a.numel() == 0:
        return 0
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max())


def phase_card():
    from kmc_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _build.build_all(verbose=True)
    log(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return card


def phase_scan():
    from kmc_tpu_torch.io.readers import batch_len
    from kmc_tpu_torch.ops.extract_kernel import (extract_splitter_scan,
                                                  splitter_scan_plain)

    s = 1 << 22
    rng = np.random.default_rng(2)
    rows = {}
    reset_counts()  # the entry's own run: the first call at each shape
    for k in (27, 32, 33, 55, 129, 256):
        codes_h = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
        codes_h[rng.random(len(codes_h)) < 0.01] = 4
        codes = torch.from_numpy(codes_h).cuda()
        W = (k + 15) // 16
        for both in (True, False):
            sig_k, lanes_k = extract_splitter_scan(
                codes, s=s, k=k, sig_len=M, both_strands=both)
            launches = extract_splitter_scan.launches
            sig_p, lanes_p = splitter_scan_plain(
                codes, s=s, k=k, sig_len=M, both_strands=both)
            torch.cuda.synchronize()
            err = max(max_abs_err(sig_k, sig_p), max_abs_err(lanes_k, lanes_p))
            if err or not (torch.equal(sig_k, sig_p)
                           and torch.equal(lanes_k, lanes_p)):
                raise SystemExit(f"splitter scan k={k} both={both}: kernel "
                                 f"differs from plain (max_abs_err {err})")
            ms = cuda_ms(lambda: extract_splitter_scan(
                codes, s=s, k=k, sig_len=M, both_strands=both), 20)
            plain_ms = cuda_ms(lambda: splitter_scan_plain(
                codes, s=s, k=k, sig_len=M, both_strands=both), 3)
            extract_splitter_scan.launches = launches
            nbytes = batch_len(s, k) + 4 * (1 + W) * s
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            instr_ms = instr_bound_ms(k, s)
            rows[(k, both)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bytes_ms,
                bound_by="bytes", max_abs_err=err)
            log(f"[phase 2] splitter scan s=2^22 k={k} both={both}: "
                f"bit-exact, kernel_ms {ms:.4f} plain_ms {plain_ms:.3f} "
                f"bound_ms {bytes_ms:.4f} (bytes: {nbytes}; share "
                f"{bytes_ms / ms:.2f}); the design's SASS instructions "
                f"{instr_ms:.4f} ms (diagnostic)")
        del codes
    for row in rows.values():
        row["launches"] = launches
    return rows


def read_like_codes(L, seed, tail=0, read=150):
    """L codes as the parser writes them: random reads of `read` bases,
    each followed by a separator (4), an N base per thousand, and `tail`
    trailing sentinels (batch padding: tail_start = L - tail)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[read::read + 1] = 4
    codes[rng.random(L) < 1e-3] = 4
    if tail:
        codes[L - tail:] = 4
    return codes


def _profiled_device(fn, reps, attempts=3):
    """(device ms, device items) per call of fn, summed over the kernel,
    copy and memset spans that torch.profiler saw in reps calls; a trace
    with no device span (the profiler now and then records none) is taken
    again, up to `attempts` times, and then (None, None, {})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        trace = WORK / "ingest_trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
        trace.unlink()
        dev = [e for e in events if e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
        if dev:
            break
    else:
        return None, None, {}
    by_name = {}
    for e in dev:
        name = re.findall(r"(\w+)(?:<[^(]*>)?\(",
                          e["name"].replace("(anonymous namespace)", ""))
        name = name[0] if name else e["name"][:40]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"]) / 1e3 / reps
    return (sum(float(e["dur"]) for e in dev) / 1e3 / reps,
            len(dev) / reps, by_name)


def phase_store_ingest(s=1 << 22, k=27):
    """One batch through DeviceKmerStore.ingest_boundaries / ingest_fused
    on the card, as the ingest worker calls them: s = 2^22, k = 27, both
    strands, both feeds, with and without a counts column, n_used at a
    non-aligned offset.  Stream time from CUDA events over back-to-back
    batches; device time and device items per batch from torch.profiler."""
    from kmc_tpu_torch.io.native import (pack_codes_boundaries,
                                         pack_codes_fused)
    from kmc_tpu_torch.io.readers import batch_len
    from kmc_tpu_torch.ops.store import DeviceKmerStore

    L = batch_len(s, k)
    codes = read_like_codes(L, seed=5, tail=1000)
    buf_b, ts = pack_codes_boundaries(codes)
    if buf_b is None:
        raise SystemExit("phase 2: read-like codes do not fit the "
                         "boundary-delta feed")
    feeds = {"bounds": torch.from_numpy(buf_b).cuda(),
             "mask": torch.from_numpy(pack_codes_fused(codes)).cuda()}
    n0 = 12345
    rows = {}
    for feed, buf in feeds.items():
        for with_counts in (False, True):
            st = DeviceKmerStore(n0 + s, k=k, sig_len=M, both_strands=True,
                                 n_bins=512, device="cuda")
            st.n_used = n0
            if with_counts:
                st._materialize_counts()

            def one():
                st.n_used = n0
                if feed == "bounds":
                    st.ingest_boundaries(buf, ts, s=s)
                else:
                    st.ingest_fused(buf, s=s)

            ms = cuda_ms(one, 20)
            dev_ms, items, by_name = _profiled_device(one, 10)
            rows[(feed, with_counts)] = dict(ms=ms, device_ms=dev_ms,
                                             items=items)
            log(f"[phase 2] store ingest s=2^22 k={k} feed={feed} counts="
                f"{with_counts}: stream_ms {ms:.4f} (CUDA events, "
                f"back-to-back batches), device_ms {dev_ms} per batch over "
                f"{items} device items (torch.profiler: " + ", ".join(
                    f"{n} {t:.4f}" for n, t in by_name.items()) + ")")
            del st
    del feeds
    torch.cuda.empty_cache()
    return rows


INGEST_KS = (14, 27, 32, 33, 55, 256)


def sass_loops(entry_substr):
    """The loops of each kernel of the extract library built from the
    current csrc/extract.cu whose name holds entry_substr, from its SASS
    (cuobjdump -sass): (first, last address, instructions, opcode counts)
    per backward branch."""
    import collections

    from kmc_tpu_torch import _build

    so = str(_build._lib_path("extract"))
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name = part.splitlines()[0].strip()
        if entry_substr not in name:
            continue
        ins = []
        for line in part.splitlines():
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                op = re.sub(r"^@!?U?P[T0-9]\s+", "", m.group(2).strip())
                ins.append((int(m.group(1), 16), op.split()[0],
                            m.group(2)))
        loops = []
        for a, op, text in ins:
            m = re.search(r"BRA\s+(?:U?!?P\w+,\s*)?(?:`\(\.L_x_\d+\)\s*)?"
                          r"0x([0-9a-f]+)", text)
            if op == "BRA" and m and int(m.group(1), 16) < a:
                lo = int(m.group(1), 16)
                body = collections.Counter(o for b, o, _ in ins
                                           if lo <= b <= a)
                loops.append((lo, a, sum(body.values()), body))
        out[name] = (len(ins), loops)
    return out


INSTR_PER_S = 132 * 4 * 32 * 1.98e9  # H100 SXM: 4 warp instructions a clock
# an SM, 32 threads each, at the 1,980 MHz boost clock
_INSTR = {}


def instr_per_position(feed, k):
    """Integer instructions one position costs the scan kernel of `feed`
    (0 codes, 1 packed+mask, 2 boundary-delta), read from its SASS, whose
    loops keep the source's order: the staging loops (before the m-mer key
    loop, per 16 codes), the key loop (the one with BREV; per key), the
    sliding minimum's chunk loop (its first loop; per 8 keys), run loop
    (the widest; per run) and combine loop (after it; per x), then the
    output loop (the widest with STG: its body outside inner loops, plus
    one lane store per lane past the first).  Each body is weighted by
    its trips per position at this k; branches inside a body count whole,
    so this errs high.  Returns (instructions, parts)."""
    from kmc_tpu_torch.ops.ingest_kernel import TILE

    if feed not in _INSTR:
        _INSTR[feed] = sass_loops(f"scan_kernelILi{feed}E")
    (_, loops), = _INSTR[feed].values()
    w = k - M + 1
    W = (k + 15) // 16
    nseg = (TILE + w) // w
    keys = max((nseg + 1) * w, TILE + k) / TILE  # keys per position

    def count(lp, op):
        return sum(n for o, n in lp[3].items() if o.startswith(op))

    def innermost(lp):
        return not any(q is not lp and lp[0] <= q[0] and q[1] <= lp[1]
                       for q in loops)

    key = min((lp for lp in loops if count(lp, "BREV")),
              key=lambda lp: lp[2])
    # no loop holds the key loop: a backward branch around it is the
    # out-of-line code of a divergent shuffle, not a loop
    loops = [lp for lp in loops if not (lp[0] < key[0] and key[1] < lp[1])]
    out = max((lp for lp in loops if count(lp, "STG")),
              key=lambda lp: lp[1] - lp[0])
    mins = sorted((lp for lp in loops if key[1] < lp[0] and lp[1] < out[0]),
                  key=lambda lp: lp[0])
    runs = max(mins, key=lambda lp: lp[1] - lp[0])
    chunk = next(lp for lp in mins if innermost(lp))
    combine = max((lp for lp in mins if lp[0] > runs[1] and innermost(lp)),
                  key=lambda lp: count(lp, "STS"))
    inner = [lp for lp in loops if lp is not out and out[0] <= lp[0]
             and lp[1] <= out[1]]
    lane = min((lp[2] / count(lp, "STG") for lp in inner
                if count(lp, "STG")), default=0)
    parts = {
        "staging": sum(lp[2] for lp in loops if lp[1] < key[0]) / 16,
        "keys": key[2] / count(key, "BREV") * keys,
        "minimum": (chunk[2] / 8 * keys + runs[2] * (nseg + 1) / TILE
                    + combine[2] / count(combine, "STS")),
        "output": out[2] - sum(lp[2] for lp in inner) + lane * (W - 1),
    }
    return sum(parts.values()), parts


def instr_bound_ms(k, s, feed=0):
    """The least time the card needs to run this design's instructions
    for s positions (instr_per_position over INSTR_PER_S).  A diagnostic
    of the design, printed beside the bound: the count is the design's own
    and errs high, so it is never the kernel's bound_ms."""
    n, _ = instr_per_position(feed, k)
    return n * s / INSTR_PER_S * 1e3


def _ingest_state(k, s, n0, with_counts, seed):
    """Store state on the card: random columns (rows the ingest must not
    touch included), a counts column or None, accumulators near 2^32 and a
    prev_sig, for `batches` batches of s rows from row n0."""
    from kmc_tpu_torch.ops.store import prefix_bin_bits

    prefix_bits, fuse = prefix_bin_bits(k, M, 512)
    n_cols = (k + 15) // 16 + (0 if fuse else 1)
    cap = n0 + 2 * s + 8
    g = torch.Generator(device="cuda").manual_seed(seed)

    def col():
        return torch.randint(-2**31, 2**31 - 1, (cap,), generator=g,
                             dtype=torch.int32, device="cuda")

    return dict(cols=[col() for _ in range(n_cols)],
                counts=col() if with_counts else None,
                n_used=n0,
                occ=torch.tensor(2**32 - 11, dtype=torch.int64, device="cuda"),
                skm=torch.tensor(3, dtype=torch.int64, device="cuda"),
                prev=torch.tensor([-1], dtype=torch.int32, device="cuda"),
                kw=dict(k=k, sig_len=M, prefix_bits=prefix_bits, fuse=fuse))


def _clone_state(st):
    out = dict(st)
    out["cols"] = [c.clone() for c in st["cols"]]
    for key in ("counts", "occ", "skm", "prev"):
        out[key] = None if st[key] is None else st[key].clone()
    return out


def _run_ingest(fn, st, buf, ts, s, both):
    st["prev"] = fn(buf, ts, st["cols"], st["counts"], st["n_used"],
                    st["occ"], st["skm"], st["prev"], s=s, both_strands=both,
                    **st["kw"])
    st["n_used"] += s


def _torch_op_route(st, buf, ts, s, both):
    """The parent's route, as a yardstick: the feed decoded by torch ops,
    the scan kernel on the decoded codes, the binning by torch ops."""
    from kmc_tpu_torch.ops.extract_kernel import extract_splitter_scan
    from kmc_tpu_torch.ops.ingest_kernel import (bin_and_append,
                                                 decode_boundaries,
                                                 decode_fused)

    kw = st["kw"]
    k = kw["k"]
    codes = (decode_fused(buf, s=s, k=k) if ts is None
             else decode_boundaries(buf, ts, s=s, k=k))
    sig, lanes = extract_splitter_scan(codes, s=s, k=k, sig_len=M,
                                       both_strands=both)
    W = (k + 15) // 16
    bin_and_append(sig, lanes, st["cols"], st["counts"], st["n_used"],
                   st["occ"], st["skm"], st["prev"], sig_len=M,
                   prefix_bits=kw["prefix_bits"], fuse=kw["fuse"],
                   r0=k - 16 * (W - 1))


def phase_ingest(s=1 << 22):
    """The fused ingest kernel against ingest_plain on the card, bit for
    bit: s = 2^22, k in INGEST_KS, both feeds, both strands and one, with
    and without a counts column; n_used = 12345 (not a multiple of 4),
    tail_start inside the first batch, two batches in a row (prev_sig
    carries).  Then times at both strands without counts: kernel, plain
    version, the parent's torch-op route, and the bound."""
    from kmc_tpu_torch.io.native import (pack_codes_boundaries,
                                         pack_codes_fused)
    from kmc_tpu_torch.io.readers import batch_len
    from kmc_tpu_torch.ops.ingest_kernel import ingest, ingest_plain

    for feed, name in enumerate(("codes", "packed+mask", "boundary-delta")):
        n, parts = instr_per_position(feed, 27)
        log(f"[phase 2] SASS of the scan kernel on the {name} feed, k=27: "
            f"{n:.1f} instructions a position (" + ", ".join(
                f"{part} {v:.1f}" for part, v in parts.items()) + ")")
    rows = {}
    for k in INGEST_KS:
        L = batch_len(s, k)
        read = max(150, 2 * k)  # reads long enough to hold k-mers
        codes = [read_like_codes(L, seed=k, tail=1000, read=read),
                 read_like_codes(L, seed=k + 1, read=read)]
        feeds = {"bounds": [], "mask": []}
        for c in codes:
            buf, ts = pack_codes_boundaries(c)
            feeds["bounds"].append((torch.from_numpy(buf).cuda(), ts))
            feeds["mask"].append((torch.from_numpy(pack_codes_fused(c))
                                  .cuda(), None))
        for feed, batches in feeds.items():
            for both in (True, False):
                for with_counts in (False, True):
                    base = _ingest_state(k, s, 12345, with_counts, seed=k)
                    got, want = _clone_state(base), _clone_state(base)
                    for buf, ts in batches:
                        _run_ingest(ingest, got, buf, ts, s, both)
                        _run_ingest(ingest_plain, want, buf, ts, s, both)
                    torch.cuda.synchronize()
                    pairs = list(zip(got["cols"], want["cols"]))
                    if with_counts:
                        pairs.append((got["counts"], want["counts"]))
                    err = max(max_abs_err(a, b) for a, b in pairs)
                    same = err == 0 and all(
                        torch.equal(got[key], want[key])
                        for key in ("occ", "skm", "prev"))
                    if not same:
                        raise SystemExit(
                            f"phase 2: fused ingest k={k} feed={feed} "
                            f"both={both} counts={with_counts} differs from "
                            f"ingest_plain (max_abs_err {err}; occ "
                            f"{int(got['occ'])}/{int(want['occ'])}, skm "
                            f"{int(got['skm'])}/{int(want['skm'])})")
                    del got, want
                    if not both or with_counts:
                        continue
                    buf, ts = batches[0]

                    def kernel(st=base):
                        _run_ingest(ingest, st, buf, ts, s, True)
                        st["n_used"] = 12345

                    def plain(st=base):
                        _run_ingest(ingest_plain, st, buf, ts, s, True)
                        st["n_used"] = 12345

                    dev_ms, _, by_name = _profiled_device(kernel, 10)
                    stream_ms = cuda_ms(kernel, 20)
                    if dev_ms is None:
                        log(f"[phase 2] fused ingest k={k} feed={feed}: "
                            "torch.profiler saw no device span; kernel_ms "
                            "is the CUDA-event stream time")
                    row = dict(
                        max_abs_err=err,
                        ms=stream_ms if dev_ms is None else dev_ms,
                        stream_ms=stream_ms,
                        kernels=by_name,
                        plain_ms=cuda_ms(plain, 3),
                        route_ms=cuda_ms(lambda: _torch_op_route(
                            base, buf, ts, s, True), 5),
                        n_cols=len(base["cols"]), feed_bytes=buf.numel())
                    nbytes = buf.numel() + 4 * row["n_cols"] * s
                    row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                    row["bound_by"] = "bytes"
                    row["instr_ms"] = instr_bound_ms(
                        k, s, 2 if feed == "bounds" else 1)
                    rows[(k, feed)] = row
                    log(f"[phase 2] fused ingest s=2^22 k={k} feed={feed}: "
                        f"bit-exact at both strands and one, with and "
                        f"without counts, over two batches; kernel_ms "
                        f"{row['ms']:.4f} (device, torch.profiler: " +
                        ", ".join(f"{n} {t:.4f}" for n, t in by_name.items())
                        + f"; stream {row['stream_ms']:.4f}, CUDA events) "
                        f"plain_ms {row['plain_ms']:.3f} "
                        f"torch-op route ms {row['route_ms']:.4f} bound_ms "
                        f"{row['bound_ms']:.4f} (bytes: {nbytes}; share "
                        f"{row['bound_ms'] / row['ms']:.2f}); the design's "
                        f"SASS instructions {row['instr_ms']:.4f} ms "
                        "(diagnostic)")
                    del base
        del feeds
        torch.cuda.empty_cache()
    return rows


GREEDY_KS = (27, 33, 55)
GREEDY_MS = (9, 11)


def greedy_map(m, seed):
    """A greedy signature -> bin map of 512 bins from build_signature_map
    on a random skewed histogram over 20,000 signatures, as a store holds
    it on the card (int32[4^m + 1], -1 slots routed to the dead bin), and
    its n_used_bins."""
    from kmc_tpu_torch.signatures import build_signature_map, map_size

    rng = np.random.default_rng(seed)
    hist = np.zeros(map_size(m), np.uint64)
    hist[rng.integers(0, map_size(m), 20000)] = (
        rng.pareto(1.2, 20000) * 1000).astype(np.uint64) + 1
    sig_map = build_signature_map(hist, m, 512)
    nb = int(sig_map.max()) + 1
    return torch.from_numpy(np.where(sig_map < 0, nb, sig_map).astype(
        np.int32)).cuda(), nb


def _greedy_state(k, m, s, n0, sig_map, nb, with_hist, seed):
    """_ingest_state for the greedy entry (sig_map given) or the prefix
    entry (None) at signature length m, with a stage-0 histogram."""
    from kmc_tpu_torch.ops.store import greedy_fuse, prefix_bin_bits
    from kmc_tpu_torch.signatures import map_size

    if sig_map is None:
        prefix_bits, fuse = prefix_bin_bits(k, m, 512)
    else:
        prefix_bits, fuse = 0, greedy_fuse(k, nb)
    n_cols = (k + 15) // 16 + (0 if fuse else 1)
    cap = n0 + 2 * s + 8
    g = torch.Generator(device="cuda").manual_seed(seed)
    return dict(
        cols=[torch.randint(-2**31, 2**31 - 1, (cap,), generator=g,
                            dtype=torch.int32, device="cuda")
              for _ in range(n_cols)],
        counts=None, n_used=n0,
        occ=torch.tensor(2**32 - 11, dtype=torch.int64, device="cuda"),
        skm=torch.tensor(3, dtype=torch.int64, device="cuda"),
        prev=torch.tensor([-1], dtype=torch.int32, device="cuda"),
        hist=(torch.full((map_size(m),), 5, dtype=torch.int32,
                         device="cuda") if with_hist else None),
        kw=dict(k=k, sig_len=m, prefix_bits=prefix_bits, fuse=fuse,
                sig_map=sig_map))


def _run_greedy(fn, st, buf, ts, s):
    st["prev"] = fn(buf, ts, st["cols"], st["counts"], st["n_used"],
                    st["occ"], st["skm"], st["prev"], s=s, both_strands=True,
                    hist=st["hist"], **st["kw"])
    st["n_used"] += s


def _clone_greedy(st):
    out = _clone_state(st)
    out["hist"] = None if st["hist"] is None else st["hist"].clone()
    return out


def touched_table_bytes(buf, ts, k, m, s):
    """Bytes of an int32[4^m + 1] table (the greedy map, the histogram)
    that one batch reaches: 32 B for each 32-byte sector that a valid
    position's signature indexes.  The distinct signatures are the
    nonzero slots of the plain version's histogram of the batch."""
    from kmc_tpu_torch.ops.ingest_kernel import ingest_plain

    st = _greedy_state(k, m, s, 0, None, 0, True, seed=0)
    st["hist"].zero_()
    _run_greedy(ingest_plain, st, buf, ts, s)
    sigs = torch.nonzero(st["hist"]).flatten()
    return 32 * torch.unique(sigs >> 3).numel()


def phase_ingest_greedy(s=1 << 22):
    """The fused ingest's greedy entry (bin = map[min(sig, 4^m)]) and its
    stage-0 histogram output against ingest_plain on the card, bit for
    bit: s = 2^22, m in GREEDY_MS, k in GREEDY_KS, both feeds, the greedy
    entry with and without the histogram and the prefix entry with it,
    two batches in a row from n_used = 12345.  Then at k = 27 on the
    boundary-delta feed: the greedy entry's time (m = 9 and 11) and the
    prefix entry's with the histogram (m = 9, the deferred fold's
    launches), device time from torch.profiler as the prefix entry's in
    phase_ingest, each beside its plain version and its bound by bytes
    (the feed, the rows, the map sectors the batch's signatures touch read
    once, the histogram's read and written once)."""
    from kmc_tpu_torch.io.native import (pack_codes_boundaries,
                                         pack_codes_fused)
    from kmc_tpu_torch.io.readers import batch_len
    from kmc_tpu_torch.ops.ingest_kernel import ingest, ingest_plain
    from kmc_tpu_torch.signatures import map_size

    rows = {}
    for m in GREEDY_MS:
        t0 = time.perf_counter()
        sig_map, nb = greedy_map(m, seed=m)
        log(f"[phase 2] greedy map m={m}: {nb} bins, built in "
            f"{time.perf_counter() - t0:.1f} s")
        for k in GREEDY_KS:
            L = batch_len(s, k)
            read = max(150, 2 * k)
            codes = [read_like_codes(L, seed=k + m, tail=1000, read=read),
                     read_like_codes(L, seed=k + m + 1, read=read)]
            feeds = {"bounds": [], "mask": []}
            for c in codes:
                buf, ts = pack_codes_boundaries(c)
                feeds["bounds"].append((torch.from_numpy(buf).cuda(), ts))
                feeds["mask"].append((torch.from_numpy(pack_codes_fused(c))
                                      .cuda(), None))
            for feed, batches in feeds.items():
                for entry, smap, with_hist in (("greedy", sig_map, False),
                                               ("greedy", sig_map, True),
                                               ("prefix", None, True)):
                    base = _greedy_state(k, m, s, 12345, smap, nb, with_hist,
                                         seed=k)
                    got, want = _clone_greedy(base), _clone_greedy(base)
                    before = (ingest.greedy_launches, ingest.hist_launches)
                    for buf, ts in batches:
                        _run_greedy(ingest, got, buf, ts, s)
                        _run_greedy(ingest_plain, want, buf, ts, s)
                    torch.cuda.synchronize()
                    if (ingest.greedy_launches - before[0],
                            ingest.hist_launches - before[1]) != (
                            2 * (smap is not None), 2 * with_hist):
                        raise SystemExit("phase 2: the greedy / histogram "
                                         "launches were not counted")
                    pairs = list(zip(got["cols"], want["cols"]))
                    if with_hist:
                        pairs.append((got["hist"], want["hist"]))
                    err = max(max_abs_err(a, b) for a, b in pairs)
                    if err or not all(torch.equal(got[x], want[x])
                                      for x in ("occ", "skm", "prev")):
                        raise SystemExit(
                            f"phase 2: the {entry} entry m={m} k={k} "
                            f"feed={feed} hist={with_hist} differs from "
                            f"ingest_plain (max_abs_err {err})")
                    del got, want
                    timed_row = (k == 27 and feed == "bounds"
                                 and (with_hist == (smap is None))
                                 and (smap is not None or m == 9))
                    if timed_row:
                        buf, ts = batches[0]

                        def run(fn, st=base):
                            _run_greedy(fn, st, buf, ts, s)
                            st["n_used"] = 12345

                        dev_ms, _, _ = _profiled_device(
                            lambda: run(ingest), 10)
                        row = dict(max_abs_err=err,
                                   stream_ms=cuda_ms(lambda: run(ingest), 20),
                                   plain_ms=cuda_ms(
                                       lambda: run(ingest_plain), 3))
                        row["ms"] = (row["stream_ms"] if dev_ms is None
                                     else dev_ms)
                        table = touched_table_bytes(buf, ts, k, m, s)
                        nbytes = buf.numel() + 4 * len(base["cols"]) * s
                        nbytes += table if smap is not None else 2 * table
                        row.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                                   bound_by="bytes", bytes=nbytes,
                                   table_bytes=table)
                        name = "hist" if smap is None else "greedy"
                        rows[(name, m)] = row
                        log(f"[phase 2] {name} (m={m}, k=27, "
                            f"boundary-delta, s=2^22): kernel_ms "
                            f"{row['ms']:.4f} ("
                            + ("CUDA events: torch.profiler saw no device "
                               "span" if dev_ms is None else
                               "device, torch.profiler")
                            + f"; stream {row['stream_ms']:.4f}, CUDA "
                            f"events) plain_ms {row['plain_ms']:.3f} "
                            f"bound_ms {row['bound_ms']:.4f} (bytes: "
                            f"{nbytes}, of them {table} for the "
                            f"{table // 32} map / histogram sectors the "
                            f"batch touches, of {4 * map_size(m)} in the "
                            f"table; share "
                            f"{row['bound_ms'] / row['ms']:.2f})")
                    del base
            log(f"[phase 2] greedy entry m={m} k={k}: bit-exact on both "
                "feeds with and without the histogram; the prefix entry's "
                "histogram bit-exact")
            del feeds
            torch.cuda.empty_cache()
    return rows


def _sort_columns(n, n_keys, seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 2**32 - 1, n, dtype=np.uint32)
            for _ in range(n_keys)]
    keys[0] >>= 8  # many equal leading keys, as (bin|k-mer) lane 0 has
    dead = rng.random(n) < 0.15
    for c in keys:
        c[dead] = 0xFFFFFFFF
    counts = rng.integers(1, 50, n, dtype=np.uint32)
    counts[dead] = 0
    return [torch.from_numpy(c.view(np.int32)).cuda() for c in keys + [counts]]


def _live_passes(cols, n_keys):
    """The kernel's pass plan with each pass's liveness: a pass is dead
    when one digit holds every row (what the kernel's histogram finds)."""
    from kmc_tpu_torch.ops.extract import i32_to_u32
    from kmc_tpu_torch.ops.sort_kernel import sort_plan

    n = cols[0].shape[0]
    passes, rows_mode = sort_plan(len(cols), n_keys)
    live = []
    for c, shift, width in passes:
        digits = (i32_to_u32(cols[c]) >> shift) & ((1 << width) - 1)
        live.append(int(torch.bincount(digits, minlength=1 << width).max())
                    < n)
    return passes, rows_mode, live


def _design_bytes(n, n_cols, n_keys, rows_mode, live):
    """Bytes the kernel's design moves: the histogram reads the key
    columns; a live pass reads and writes whole rows (rows mode) or a key
    word and a row index (index mode: its first live pass reads only the
    key, a new key column is gathered, 4 B a row, in place of its read);
    index mode's finish reads the index, gathers every column and writes
    it."""
    total = 4 * n * n_keys
    n_live = sum(live)
    if rows_mode:
        return total + n_live * 2 * 4 * n * n_cols
    if n_live:
        total += n_live * 16 * n - 4 * n
    return total + 4 * n + 2 * 4 * n * n_cols


SORT_SHAPES = (  # (rows, key columns, columns): the main path's layouts
    (1 << 26, 2, 3),            # k <= 27 store rows: 2 keys + counts
    ((1 << 24) + 12345, 3, 4),  # an odd length, 3 keys + counts
    (1 << 26, 1, 3),            # the senders' sort: 1 key + 2 payloads
    (1 << 24, 4, 5),            # k = 55: 4 keys + counts
    (1 << 22, 17, 18),          # k = 256: 17 keys + counts
)


def phase_sort():
    from kmc_tpu_torch.ops.extract import i32_to_u32
    from kmc_tpu_torch.ops.sort_kernel import (radix_sort_columns,
                                               radix_sort_plain,
                                               radix_sort_stage_ms)

    rows = {}
    for n, n_keys, n_cols in SORT_SHAPES:
        cols = _sort_columns(n, n_cols - 1, seed=n_keys)
        got = radix_sort_columns(cols, n_keys)
        ref = radix_sort_plain(cols, n_keys)
        torch.cuda.synchronize()
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        if err or not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise SystemExit(f"radix sort n={n} keys={n_keys}: kernel differs "
                             f"from plain (max_abs_err {err})")
        del got, ref
        ms = cuda_ms(lambda: radix_sort_columns(cols, n_keys), 5)
        plain_ms = cuda_ms(lambda: radix_sort_plain(cols, n_keys), 2)
        library_ms = None
        library = "none: no one PyTorch call sorts by 3+ keys"
        if n_keys == 2:
            # one order-preserving int64 key: (hi ^ 2^31) << 32 | lo
            hi = i32_to_u32(cols[0]) - (1 << 31)
            key = (hi << 32) | i32_to_u32(cols[1])
            del hi
            library_ms = cuda_ms(lambda: torch.sort(key), 5)
            library = "torch.sort of one packed int64 key"
            del key
        elif n_keys == 1:
            key = i32_to_u32(cols[0])
            library_ms = cuda_ms(lambda: torch.sort(key, stable=True), 5)
            library = "stable torch.sort of the int64 key"
            del key
        passes, rows_mode, live = _live_passes(cols, n_keys)
        nbytes = 2 * 4 * n * len(cols)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        moved = _design_bytes(n, len(cols), n_keys, rows_mode, live)
        rows[(n, n_keys)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 library_ms=library_ms, max_abs_err=err)
        log(f"[phase 3] radix sort n={n} keys={n_keys} columns={n_cols} "
            f"({'rows' if rows_mode else 'index'} mode, {sum(live)} of "
            f"{len(live)} passes live): identical, kernel_ms {ms:.3f} "
            f"plain_ms {plain_ms:.3f} library_ms "
            f"{library_ms if library_ms is None else round(library_ms, 3)} "
            f"({library}) bound_ms {bound_ms:.4f} ({nbytes} bytes); design "
            f"moves {moved} bytes, {moved / ms / 1e6:.1f} GB/s")
        if n == 1 << 26 and n_keys == 2:
            _, stage_ms = radix_sort_stage_ms(cols, n_keys)
            per_pass = ", ".join(
                f"col {c} shift {sh} {t:.3f}" + ("" if lv else " (dead)")
                for (c, sh, _), lv, t in zip(passes, live, stage_ms[1:-1]))
            log(f"[phase 3]   stages (ms, CUDA events): histogram + plan "
                f"{stage_ms[0]:.3f}; {per_pass}; finish {stage_ms[-1]:.3f}")
        del cols
        torch.cuda.empty_cache()
    return rows


def bench_reads(genome_len: int, coverage: int, seed: int):
    """bench.py's synthetic reads: a random genome (2-bit codes) and the
    starts of its reads of 150 bp, uniform."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    n_reads = genome_len * coverage // 150
    return genome, rng.integers(0, genome_len - 150, n_reads)


def write_fastq(path: Path, genome_len: int, coverage: int, seed: int):
    """bench_reads' reads as a FASTQ, written in blocks."""
    read_len = 150
    genome, starts = bench_reads(genome_len, coverage, seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_reads = len(starts)
    qual = b"I" * read_len
    with open(path, "wb") as f:
        block = 1 << 16
        for lo in range(0, n_reads, block):
            hi = min(lo + block, n_reads)
            idx = starts[lo:hi, None] + np.arange(read_len)[None, :]
            seqs = acgt[genome[idx]]
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), qual)
                             for i, s in enumerate(seqs, start=lo)))
    return n_reads


def run_count(fq, out, device, profiler=None, **kw):
    from kmc_tpu_torch import Runner, Stage1Params, Stage2Params

    p1 = Stage1Params(input_files=[str(fq)], kmer_len=27)
    p2 = Stage2Params(output_file_name=str(out), cutoff_min=2)
    for key, val in kw.items():
        setattr(p1 if hasattr(p1, key) else p2, key, val)
    runner = Runner(device=device)
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    r1 = runner.run_stage1(p1)
    r2 = runner.run_stage2(p2)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if profiler is not None:
        profiler.stop()
    return r1, r2, runner, wall


def _wrappers():
    from kmc_tpu_torch import microbench_sort as mb
    from kmc_tpu_torch.ops.extract_kernel import (extract_splitter_scan,
                                                  extract_splitter_scan_1d)
    from kmc_tpu_torch.ops.ingest_kernel import ingest
    from kmc_tpu_torch.ops.sort_kernel import radix_sort_columns
    from kmc_tpu_torch.parallel.exchange_kernel import (all_to_all,
                                                        ragged_all_to_all)

    return {"fused_ingest": ingest,
            "splitter_scan": extract_splitter_scan,
            "radix_sort": radix_sort_columns,
            "ragged_all_to_all": ragged_all_to_all,
            "all_to_all": all_to_all,
            "splitter_scan_1d": extract_splitter_scan_1d,
            "probe_add1": mb.probe_add1,
            "probe_gather_rows": mb.probe_gather_rows,
            "probe_gather_lanes": mb.probe_gather_lanes}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    ingest = _wrappers()["fused_ingest"]
    ingest.mask_launches = ingest.greedy_launches = ingest.hist_launches = 0


def read_counts(names=("fused_ingest", "radix_sort")):
    """Launches of the named kernels since reset_counts(); a path that
    ingests must not have taken the standalone scan entry."""
    wrappers = _wrappers()
    if "fused_ingest" in names and wrappers["splitter_scan"].launches:
        raise SystemExit("the store's ingest launched the standalone scan "
                         "entry instead of the fused ingest")
    return {name: wrappers[name].launches for name in names}


SHARDED_PATH = ("fused_ingest", "radix_sort", "ragged_all_to_all")
# the fused ingest's kernels, as the profiler names them
INGEST_KERNELS = ("scan_kernel", "delta_scan_kernel")
# the grouping sort's kernels, as the profiler names them
SORT_KERNELS = ("digit_histograms", "make_plan", "onesweep_pass",
                "finish_rows", "finish_index")
SORT_PHASE5_PEAK = 3_333_154_304  # phase 5's peak device memory with the
# one-sweep radix sort and the torch-op ingest


def phase_card_vs_cpu():
    fq = WORK / "mid.fastq"
    write_fastq(fq, 1 << 20, 10, seed=1)
    kw = dict(batch_positions=1 << 20, device_store_rows=3 << 20)
    reset_counts()
    r1, r2, runner, wall = run_count(fq, WORK / "mid_cuda", "cuda", **kw)
    launches = read_counts()
    c1, c2, c_runner, c_wall = run_count(fq, WORK / "mid_cpu", "cpu", **kw)
    n_comp, c_comp = runner.n_compactions, c_runner.n_compactions
    for suf in (".kmc_pre", ".kmc_suf"):
        a = (WORK / f"mid_cuda{suf}").read_bytes()
        b = (WORK / f"mid_cpu{suf}").read_bytes()
        if a != b:
            raise SystemExit(f"phase 4: card and CPU {suf} differ")
    if n_comp < 2 or n_comp != c_comp:
        raise SystemExit(f"phase 4: expected >= 2 compactions, got {n_comp} "
                         f"(cpu {c_comp})")
    if min(launches.values()) == 0:
        raise SystemExit(f"phase 4: a kernel never launched: {launches}")
    if (r2.n_unique_kmers, r2.n_total_kmers) != (c2.n_unique_kmers,
                                                c2.n_total_kmers):
        raise SystemExit("phase 4: card and CPU stats differ")
    log(f"[phase 4] 1 Mbp x10 k=27 -ci2: card DB == CPU DB byte for byte; "
        f"{n_comp} compactions; n_total {r2.n_total_kmers} n_unique "
        f"{r2.n_unique_kmers}; launches {launches}; card {wall:.2f} s, "
        f"cpu {c_wall:.2f} s")
    return fq


def phase_full():
    fq = WORK / "bench_8M_30x.fastq"
    t0 = time.perf_counter()
    n_reads = write_fastq(fq, 1 << 23, 30, seed=0)
    log(f"[phase 5] wrote {n_reads} reads ({fq.stat().st_size} bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r1, r2, runner, wall = run_count(fq, WORK / "bench_out", "cuda",
                                     verbose=True)
    launches = read_counts()
    n_comp = runner.n_compactions
    want = n_reads * (150 - 27 + 1)
    if r2.n_total_kmers != want:
        raise SystemExit(f"phase 5: n_total_kmers {r2.n_total_kmers} != "
                         f"{n_reads} reads x 124 = {want}")
    if min(launches.values()) == 0:
        raise SystemExit(f"phase 5: a kernel never launched: {launches}")
    kept = r2.n_unique_kmers - r2.n_below_cutoff_min - r2.n_above_cutoff_max
    suf_bytes = (WORK / "bench_out.kmc_suf").stat().st_size
    rec_bytes = (suf_bytes - 8) / max(kept, 1)
    if kept <= 0 or rec_bytes != int(rec_bytes):
        raise SystemExit(f"phase 5: .kmc_suf of {suf_bytes} bytes does not "
                         f"hold {kept} whole records")
    peak = torch.cuda.max_memory_allocated()
    if peak > SORT_PHASE5_PEAK:
        raise SystemExit(f"phase 5: max_memory_allocated {peak} is above "
                         f"the radix sort's {SORT_PHASE5_PEAK}")
    log(f"[phase 5] full size: n_total_kmers {r2.n_total_kmers} "
        f"(= {n_reads} x 124), n_unique {r2.n_unique_kmers}, kept {kept}, "
        f"wall_s {wall:.3f} stage1_s {r1.time:.3f} stage2_s {r2.time:.3f} "
        f"finalize_exec_s {r2.time_finalize_exec:.3f} finalize_d2h_s "
        f"{r2.time_finalize_d2h:.3f} compactions {n_comp} "
        f"max_memory_allocated {peak} launches {launches} "
        f"kmers_per_s {r2.n_total_kmers / wall:.0f}")
    r2.n_super_kmers = r1.n_total_super_kmers  # phase 19 holds it
    return fq, n_reads, r2


def _union_us(spans):
    """Total length of the union of (start, end) intervals."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _device_time(prof, label, wall, also=()):
    """Device busy time (union of kernel, copy and memset spans) of a
    profiled run against its wall, and the items that take the most device
    time, plus those whose names hold a string of `also`; logged under
    `label`."""
    trace = WORK / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    trace.unlink()
    dev = [e for e in events if e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        log(f"{label} the profiler saw no device events: device busy "
            "share not measured")
        return
    busy_us = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in dev)
    by_cat = {}
    by_name = {}
    for e in dev:
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + float(e["dur"])
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + float(e["dur"]))
    log(f"{label} profiled run: wall_s {wall:.3f}, device busy_s "
        f"{busy_us / 1e6:.3f} (" + ", ".join(
            f"{c} {t / 1e6:.3f}" for c, t in sorted(by_cat.items()))
        + f"), idle share {1 - busy_us / 1e6 / wall:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for i, (name, (n, t)) in enumerate(ranked):
        if i < 12 or any(a in name for a in also):
            log(f"  {t / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    _labelled_time(events, dev, label)


STORE_LABELS = ("ingest", "compact")


def device_profiler():
    """torch.profiler over the CPU (every thread: the ingest runs on a
    worker thread) and the card."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


@contextlib.contextmanager
def labelled_store():
    """Wrap DeviceKmerStore's ingest and compaction in torch.profiler
    labels ("ingest", "compact"), from outside the store, so a trace can
    group the device time each launches."""
    from torch.profiler import record_function

    from kmc_tpu_torch.ops.store import DeviceKmerStore

    saved = {name: getattr(DeviceKmerStore, name) for name in
             ("ingest_boundaries", "ingest_fused", "compact")}

    def wrap(fn, label):
        def wrapped(self, *args, **kw):
            with record_function(label):
                return fn(self, *args, **kw)
        return wrapped

    for name, fn in saved.items():
        setattr(DeviceKmerStore, name,
                wrap(fn, "compact" if name == "compact" else "ingest"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(DeviceKmerStore, name, fn)


def _labelled_time(events, dev, label):
    """Device time, device items and host launches of each store label:
    a device item belongs to the innermost label whose host range holds
    the runtime call that launched it (matched by correlation id; the
    store's ingest and compactions run on one worker thread, and no other
    thread launches while they do)."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in STORE_LABELS and "dur" in e]
    if not spans:
        return
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")]
    by_corr = {e["args"]["correlation"]: e for e in runtime
               if "correlation" in e.get("args", {})}

    def owner(e):
        ts = float(e["ts"])
        best = None
        for sp in spans:
            a = float(sp["ts"])
            if (a <= ts <= a + float(sp["dur"])
                    and (best is None or a > float(best["ts"]))):
                best = sp
        return best["name"] if best else None

    n_spans = {name: sum(1 for sp in spans if sp["name"] == name)
               for name in STORE_LABELS}
    dev_t = dict.fromkeys(STORE_LABELS, 0.0)
    items = dict.fromkeys(STORE_LABELS, 0)
    for e in dev:
        launch = by_corr.get(e.get("args", {}).get("correlation"))
        name = owner(launch) if launch else None
        if name:
            dev_t[name] += float(e["dur"])
            items[name] += 1
    calls = dict.fromkeys(STORE_LABELS, 0)
    for e in runtime:
        n = e.get("name", "")
        if "Launch" in n or "Memcpy" in n or "Memset" in n:
            name = owner(e)
            if name:
                calls[name] += 1
    for name in STORE_LABELS:
        n = max(n_spans[name], 1)
        log(f"{label} under '{name}' ({n_spans[name]} calls): device "
            f"{dev_t[name] / 1e3:.3f} ms ({dev_t[name] / 1e3 / n:.4f} ms a "
            f"call), {items[name]} device items ({items[name] / n:.1f} a "
            f"call), {calls[name]} host launch calls ({calls[name] / n:.1f}"
            " a call)")


def phase_profile(full):
    """The full-size run once more under torch.profiler: device busy time
    (union of kernel, copy and memset spans) against the wall, and the
    kernels that take the most device time."""
    fq, _, _ = full
    prof = device_profiler()
    with labelled_store():
        _, r2, _, wall = run_count(fq, WORK / "bench_prof", "cuda",
                                   profiler=prof)
    for suf in (".kmc_pre", ".kmc_suf"):
        if ((WORK / f"bench_prof{suf}").read_bytes()
                != (WORK / f"bench_out{suf}").read_bytes()):
            raise SystemExit(f"phase 6: the repeated full run's {suf} "
                             "differs from phase 5's")
    log(f"[phase 6] n_total_kmers {r2.n_total_kmers}")
    _device_time(prof, "[phase 6]", wall, also=SORT_KERNELS + INGEST_KERNELS)


def shard_devices():
    """Four shards: on distinct cards when there are two or more (up to
    four), else all on card 0."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(min(4, n))]
    return ["cuda:0"] * 4


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls on the host clock, every
    card synchronized, after one warm-up (CUDA events do not span
    cards)."""
    fn()
    _sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync_all()
    return (time.perf_counter() - t0) / reps * 1e3


def one_ms(fn):
    """CUDA-event milliseconds of one fn() on card 0."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_exchange():
    """The exchange kernel against its plain version on card 0, 4 shards of
    [4, 2^24, C]: bit-exact delivered prefixes, then times."""
    from kmc_tpu_torch.parallel.exchange_kernel import (
        all_to_all, all_to_all_plain, ragged_all_to_all,
        ragged_all_to_all_plain)

    D, cap = 4, 1 << 24
    rows = {}
    for C in (2, 3):
        gen = torch.Generator(device="cuda").manual_seed(C)
        xs = [torch.randint(-2**31, 2**31 - 1, (D, cap, C), generator=gen,
                            dtype=torch.int32, device="cuda")
              for _ in range(D)]
        rng = np.random.default_rng(C)
        n_rows = rng.integers(0, cap + 1, size=(D, D))
        n_rows[0, 1] = 0
        n_rows[1, 2] = cap
        n_rows[2, 3] = 12345
        before = (ragged_all_to_all.launches, all_to_all.launches)
        outs, rr = ragged_all_to_all(xs, n_rows)
        ref, rr_ref = ragged_all_to_all_plain(xs, n_rows)
        torch.cuda.synchronize()
        if ragged_all_to_all.launches != before[0] + 1:
            raise SystemExit(f"phase 7: the ragged exchange of 4 shards on "
                             f"one card launched "
                             f"{ragged_all_to_all.launches - before[0]} "
                             "kernels, not one")
        if not np.array_equal(rr, rr_ref) or not np.array_equal(rr, n_rows.T):
            raise SystemExit(f"phase 7: recv_rows differ (C={C})")
        err = 0
        for r in range(D):
            for j in range(D):
                m = int(rr[r, j])
                err = max(err, max_abs_err(outs[r][j, :m], ref[r][j, :m]))
                if not torch.equal(outs[r][j, :m], ref[r][j, :m]):
                    raise SystemExit(f"phase 7: ragged exchange C={C} owner "
                                     f"{r} sender {j} differs from plain "
                                     f"(max_abs_err {err})")
        del outs, ref
        dense = all_to_all(xs)
        dense_ref = all_to_all_plain(xs)
        torch.cuda.synchronize()
        if all_to_all.launches != before[1] + 1:
            raise SystemExit("phase 7: the dense exchange of 4 shards on one "
                             "card did not launch one kernel")
        for got, want in zip(dense, dense_ref):
            err = max(err, max_abs_err(got, want))
            if not torch.equal(got, want):
                raise SystemExit(f"phase 7: dense exchange C={C} differs "
                                 f"from plain (max_abs_err {err})")
        del dense, dense_ref
        r_bytes = 2 * 4 * C * int(n_rows.sum())
        d_bytes = 2 * 4 * C * D * D * cap
        all_to_all.launches = 0
        row = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: ragged_all_to_all(xs, n_rows), 10),
            plain_ms=cuda_ms(lambda: ragged_all_to_all_plain(xs, n_rows), 3),
            bound_ms=r_bytes / HBM_BYTES_PER_S * 1e3,
            dense_ms=cuda_ms(lambda: all_to_all(xs), 10),
            dense_plain_ms=cuda_ms(lambda: all_to_all_plain(xs), 3),
            dense_bound_ms=d_bytes / HBM_BYTES_PER_S * 1e3,
            library_ms=cuda_ms(
                lambda: torch.stack(xs).transpose(0, 1).contiguous(), 3),
            dense_launches=all_to_all.launches)
        if C == 2:
            # one exchange right after others (the card busy) and after the
            # card idled 0.3 s, as a count's exchange follows host work
            row["busy_ms"] = [one_ms(lambda: ragged_all_to_all(xs, n_rows))
                              for _ in range(3)]
            row["after_idle_ms"] = []
            for _ in range(3):
                time.sleep(0.3)
                row["after_idle_ms"].append(
                    one_ms(lambda: ragged_all_to_all(xs, n_rows)))
            log(f"[phase 7] one ragged exchange (C=2) by CUDA events: "
                f"busy card {[round(t, 4) for t in row['busy_ms']]} ms, "
                f"after 0.3 s idle "
                f"{[round(t, 4) for t in row['after_idle_ms']]} ms")
        rows[C] = row
        log(f"[phase 7] exchange D={D} cap=2^24 C={C}: bit-exact; ragged "
            f"({int(n_rows.sum())} rows, {r_bytes} bytes) kernel_ms "
            f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} bound_ms "
            f"{row['bound_ms']:.4f}; dense ({d_bytes} bytes) kernel_ms "
            f"{row['dense_ms']:.4f} plain_ms {row['dense_plain_ms']:.4f} "
            f"bound_ms {row['dense_bound_ms']:.4f}; library_ms (stack + "
            f"transpose, every padded row) {row['library_ms']:.4f}; dense "
            f"launches {row['dense_launches']}")
        del xs
        torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        rows["cross"] = phase_exchange_cross_cards()
    return rows


def phase_exchange_cross_cards():
    """The exchange with each shard on its own card (one launch a card,
    each card pushing its sender's rows to the other cards' outputs over
    NVLink): bit-exact against the plain version with one launch a card,
    timed on the host clock around whole exchanges (events do not span
    cards)."""
    from kmc_tpu_torch.parallel.exchange_kernel import (
        ragged_all_to_all, ragged_all_to_all_plain)

    devices = shard_devices()
    D, cap, C = len(devices), 1 << 24, 2
    xs = [torch.randint(-2**31, 2**31 - 1, (D, cap, C), dtype=torch.int32,
                        device=d) for d in devices]
    n_rows = np.random.default_rng(7).integers(0, cap + 1, size=(D, D))
    before = ragged_all_to_all.launches
    outs, rr = ragged_all_to_all(xs, n_rows)
    ref, _ = ragged_all_to_all_plain(xs, n_rows)
    _sync_all()
    if ragged_all_to_all.launches != before + len(set(devices)):
        raise SystemExit("phase 7: the cross-card exchange did not launch "
                         "once a card")
    for r in range(D):
        for j in range(D):
            m = int(rr[r, j])
            if not torch.equal(outs[r][j, :m], ref[r][j, :m]):
                raise SystemExit(f"phase 7: cross-card exchange owner {r} "
                                 f"sender {j} differs from plain")
    del outs, ref

    row_b = 4 * C
    peer = n_rows * (1 - np.eye(D, dtype=np.int64))  # rows crossing cards
    link_b = max(peer.sum(0).max(), peer.sum(1).max()) * row_b
    bound_ms = link_b / NVLINK_BYTES_PER_S * 1e3
    ms = host_ms(lambda: ragged_all_to_all(xs, n_rows), 10)
    plain_ms = host_ms(lambda: ragged_all_to_all_plain(xs, n_rows), 3)
    log(f"[phase 7] cross-card exchange on {devices}, cap=2^24 C={C}: "
        f"bit-exact, one launch a card; {int(n_rows.sum())} rows, "
        f"{int(peer.sum()) * row_b} bytes over NVLink (busiest link "
        f"direction {int(link_b)} bytes); kernel_ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} (host clock, mean of 10) bound_ms {bound_ms:.4f} "
        "(450 GB/s each way)")
    del xs
    for d in devices:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def _same_db(a: Path, b: Path) -> bool:
    return all((a.parent / (a.name + suf)).read_bytes()
               == (b.parent / (b.name + suf)).read_bytes()
               for suf in (".kmc_pre", ".kmc_suf"))


def run_sharded(fq, out, devices, **kw):
    """distributed_count at k = 27 and -ci2 unless kw sets them: (stats,
    wall seconds)."""
    from kmc_tpu_torch import distributed_count

    t0 = time.perf_counter()
    stats = distributed_count([str(fq)], str(out), devices=devices,
                              **dict(dict(k=27, cutoff_min=2), **kw))
    if devices[0].startswith("cuda"):
        _sync_all()
    return stats, time.perf_counter() - t0


def phase_sharded_mid(fq):
    """distributed_count on phase 4's FASTQ, card vs CPU and vs phase 4's
    single-device card DB.  Phase 4's batches (2^20 positions) make only 3
    groups of 4, too few to compact twice; 2^18-position batches into
    shards of 1.5 M rows compact every shard at least twice."""
    devices = shard_devices()
    kw = dict(batch_positions=1 << 18, capacity_rows_per_device=3 << 19)
    reset_counts()
    st, wall = run_sharded(fq, WORK / "mid_sharded_cuda", devices, **kw)
    launches = read_counts(SHARDED_PATH)
    c_st, c_wall = run_sharded(fq, WORK / "mid_sharded_cpu",
                               ["cpu"] * len(devices), **kw)
    if not _same_db(WORK / "mid_sharded_cuda", WORK / "mid_sharded_cpu"):
        raise SystemExit("phase 8: sharded card and CPU databases differ")
    if not _same_db(WORK / "mid_sharded_cuda", WORK / "mid_cuda"):
        raise SystemExit("phase 8: sharded database differs from phase 4's "
                         "single-device one")
    keys = ("n_unique", "n_total", "n_below", "n_above", "n_super_kmers",
            "n_reads", "n_compactions")
    if any(st[key] != c_st[key] for key in keys):
        raise SystemExit(f"phase 8: card and CPU stats differ: {st} {c_st}")
    if st["n_compactions"] < 2:
        raise SystemExit(f"phase 8: expected >= 2 compactions per shard, got "
                         f"{st['n_compactions']}")
    if min(launches.values()) == 0:
        raise SystemExit(f"phase 8: a kernel never launched: {launches}")
    log(f"[phase 8] sharded 1 Mbp x10 k=27 -ci2 on {devices}: card DB == CPU "
        f"DB == phase 4 DB byte for byte; {st['n_compactions']} compactions "
        f"per shard; n_total {st['n_total']} n_unique {st['n_unique']}; "
        f"launches {launches}; card {wall:.2f} s, cpu {c_wall:.2f} s")

    # shards of 2^19 rows against ~1 M unique k-mers a shard: they spill,
    # and the owners merge the spilled runs on their cards
    kw = dict(batch_positions=1 << 18, capacity_rows_per_device=1 << 19)
    reset_counts()
    st, wall = run_sharded(fq, WORK / "mid_sharded_spill_cuda", devices, **kw)
    launches = read_counts(SHARDED_PATH)
    c_st, c_wall = run_sharded(fq, WORK / "mid_sharded_spill_cpu",
                               ["cpu"] * len(devices), **kw)
    for other in ("mid_sharded_spill_cpu", "mid_cuda"):
        if not _same_db(WORK / "mid_sharded_spill_cuda", WORK / other):
            raise SystemExit(f"phase 8: the spilling sharded card DB differs "
                             f"from {other}")
    keys += ("n_spills", "n_remerges")
    if any(st[key] != c_st[key] for key in keys):
        raise SystemExit(f"phase 8: spilling card and CPU stats differ: {st} "
                         f"{c_st}")
    if st["n_spills"] < 1 or st["merge_launches"] < 1:
        raise SystemExit(f"phase 8: the shards never spilled or the merge "
                         f"never sorted on the card: {st}")
    if min(launches.values()) == 0:
        raise SystemExit(f"phase 8: a kernel never launched: {launches}")
    log(f"[phase 8] spilling sharded count (shards of 2^19 rows): card DB == "
        f"CPU DB == phase 4 DB byte for byte; {st['n_compactions']} "
        f"compactions, {st['n_spills']} spills, {st['n_remerges']} re-merges, "
        f"finalize_exec_s (owners' merges) "
        f"{st['timings']['finalize_exec_s']:.3f}, radix-sort launches in "
        f"the merges {st['merge_launches']}; launches {launches}; card "
        f"{wall:.2f} s, cpu {c_wall:.2f} s")


def phase_sharded_full(full):
    """distributed_count at full size: phase 5's input and knobs, the -m 12
    plan per shard."""
    fq, n_reads, _ = full
    devices = shard_devices()
    kind = ("distinct cards" if len(set(devices)) > 1
            else "4 shards on card 0")
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    reset_counts()
    st, wall = run_sharded(fq, WORK / "bench_sharded", devices,
                           batch_positions=1 << 22,
                           capacity_rows_per_device=None)
    launches = read_counts(SHARDED_PATH)
    want = n_reads * (150 - 27 + 1)
    if st["n_total"] != want:
        raise SystemExit(f"phase 9: n_total {st['n_total']} != {n_reads} "
                         f"reads x 124 = {want}")
    if not _same_db(WORK / "bench_sharded", WORK / "bench_out"):
        raise SystemExit("phase 9: sharded database differs from phase 5's")
    if min(launches.values()) == 0:
        raise SystemExit(f"phase 9: a kernel never launched: {launches}")
    peaks = {i: torch.cuda.max_memory_allocated(i)
             for i in range(torch.cuda.device_count())}
    t = st["timings"]
    log(f"[phase 9] sharded full size on {devices} ({kind}): DB == phase 5 "
        f"DB byte for byte; n_total {st['n_total']} (= {n_reads} x 124), "
        f"n_unique {st['n_unique']}, wall_s {wall:.3f}, " + ", ".join(
            f"{key} {t[key]:.3f}" for key in (
                "ingest_wall_s", "owner_hist_s", "exchange_groupsort_s",
                "finalize_exec_s", "finalize_d2h_s", "finalize_wall_s"))
        + f", compactions {st['n_compactions']}, max_memory_allocated "
        f"{peaks}, launches {launches}, exchange_bytes "
        f"{st['exchange_bytes']}, kmers_per_s {st['n_total'] / wall:.0f}")

    # where the device time of the sharded run goes: the same run again,
    # under torch.profiler
    with labelled_store(), device_profiler() as prof:
        _, p_wall = run_sharded(fq, WORK / "bench_sharded_prof", devices,
                                batch_positions=1 << 22,
                                capacity_rows_per_device=None)
    if not _same_db(WORK / "bench_sharded_prof", WORK / "bench_out"):
        raise SystemExit("phase 9: the profiled sharded database differs "
                         "from phase 5's")
    _device_time(prof, "[phase 9]", p_wall,
                 also=("ragged_a2a",) + SORT_KERNELS + INGEST_KERNELS)
    return launches


def phase_last_kernels():
    """The 1-D splitter-scan entry and the three memory probes: each run
    once through its own entry with the counts set to 0 (the launches of
    the kernels line), then held bit for bit against its plain version and
    timed."""
    from kmc_tpu_torch import microbench_sort as mb
    from kmc_tpu_torch.io.readers import batch_len
    from kmc_tpu_torch.ops.extract_kernel import (extract_splitter_scan_1d,
                                                  splitter_scan_plain)

    s = 1 << 22
    shapes = [(k, both) for k in (21, 27, 33, 55) for both in (True, False)]
    rng = np.random.default_rng(10)
    inputs = {}
    for k in sorted({k for k, _ in shapes}):
        codes_h = rng.integers(0, 4, s + 2048).astype(np.uint8)
        codes_h[rng.random(len(codes_h)) < 0.01] = 4
        inputs[k] = torch.from_numpy(codes_h).cuda()
    # the 1-D entry's own path: one call per shape
    reset_counts()
    outs = {(k, both): extract_splitter_scan_1d(
        inputs[k], s=s, k=k, sig_len=M, both_strands=both)
        for k, both in shapes}
    torch.cuda.synchronize()
    launches = read_counts(("splitter_scan_1d",))
    if launches["splitter_scan_1d"] != len(shapes):
        raise SystemExit(f"phase 10: 1-D entry launched {launches}, "
                         f"expected {len(shapes)}")
    scan_rows = {}
    for (k, both), (sig_k, lanes_k) in outs.items():
        codes = inputs[k]
        sig_p, lanes_p = splitter_scan_plain(codes, s=s, k=k, sig_len=M,
                                             both_strands=both)
        lanes_k = torch.stack(lanes_k)
        err = max(max_abs_err(sig_k, sig_p), max_abs_err(lanes_k, lanes_p))
        if err or not (torch.equal(sig_k, sig_p)
                       and torch.equal(lanes_k, lanes_p)):
            raise SystemExit(f"phase 10: 1-D splitter scan k={k} both={both}"
                             f" differs from plain (max_abs_err {err})")
        del sig_p, lanes_p
        W = (k + 15) // 16
        nbytes = batch_len(s, k) + 4 * (1 + W) * s
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        instr_ms = instr_bound_ms(k, s)
        row = dict(
            ms=cuda_ms(lambda: extract_splitter_scan_1d(
                codes, s=s, k=k, sig_len=M, both_strands=both), 20),
            plain_ms=cuda_ms(lambda: splitter_scan_plain(
                codes, s=s, k=k, sig_len=M, both_strands=both), 3),
            bound_ms=bytes_ms, bound_by="bytes",
            max_abs_err=err, launches=launches["splitter_scan_1d"])
        scan_rows[(k, both)] = row
        log(f"[phase 10] 1-D splitter scan s=2^22 k={k} both={both}: "
            f"bit-exact, kernel_ms {row['ms']:.4f} plain_ms "
            f"{row['plain_ms']:.3f} bound_ms {bytes_ms:.4f} (bytes: "
            f"{nbytes}; share {bytes_ms / row['ms']:.2f}); the design's "
            f"SASS instructions {instr_ms:.4f} ms (diagnostic)")
    del outs, inputs
    torch.cuda.empty_cache()

    # the probes' own path: the microbench section's entry at N = 2^28
    n = 1 << 28
    names = ("probe_add1", "probe_gather_rows", "probe_gather_lanes")
    reset_counts()
    timed = mb.sec_pallas(n, device="cuda")
    torch.cuda.synchronize()
    probe_launches = read_counts(names)
    if min(probe_launches.values()) == 0:
        raise SystemExit(f"phase 10: a probe never launched: "
                         f"{probe_launches}")
    x, idx, idxl = mb.probe_inputs(n, "cuda")
    args = {"probe_add1": (x,), "probe_gather_rows": (x, idx),
            "probe_gather_lanes": (x, idxl)}
    probe_rows = {}
    for name in names:
        got = getattr(mb, name)(*args[name])
        want = getattr(mb, name + "_plain")(*args[name])
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err or not torch.equal(got, want):
            raise SystemExit(f"phase 10: {name} differs from plain "
                             f"(max_abs_err {err})")
        del got, want
        t = timed[name]
        probe_rows[name] = dict(ms=t["ms"], plain_ms=t["library_ms"],
                                library_ms=t["library_ms"],
                                bound_ms=t["bound_ms"], max_abs_err=err,
                                launches=probe_launches[name])
        log(f"[phase 10] {name} N=2^28: bit-exact, kernel_ms {t['ms']:.4f} "
            f"({t['gbs']:.1f} GB/s) bound_ms {t['bound_ms']:.4f} "
            f"library_ms {t['library_ms']:.4f}; launches "
            f"{probe_launches[name]}")
    del x, idx, idxl, args
    torch.cuda.empty_cache()

    # the grouping sort alone: the microbench tool's sort section at 2^26
    for label, t in mb.sec_sort(1 << 26, device="cuda").items():
        log(f"[phase 10] sort section {label}: kernel_ms {t['ms']:.4f} "
            f"({t['gbs']:.1f} GB/s of the byte bound) library_ms "
            f"{t['library_ms']:.4f} bound_ms {t['bound_ms']:.4f}")
    torch.cuda.empty_cache()
    # the tool's other sections (torch ops, no kernel of the port's) at 2^26
    t0 = time.perf_counter()
    for name in ("roofline", "bitonic", "scatter", "onehot"):
        for label, t in mb.SECTIONS[name](1 << 26, device="cuda").items():
            rate = (f", {t['gbs']:.1f} GB/s" if "gbs" in t else "")
            log(f"[phase 10] {name} section {label}: {t['ms']:.4f} ms"
                + rate)
        torch.cuda.empty_cache()
    log(f"[phase 10] roofline, bitonic, scatter and onehot sections in "
        f"{time.perf_counter() - t0:.1f} s")
    return scan_rows, probe_rows


MID_SPILL = {  # phase 11's stores: (batch positions, store rows) per route
    "replay": (1 << 18, 9 << 17),
    "host": (1 << 18, 1 << 19),
}


def phase_spill_mid(fq):
    """The spilling count on phase 4's FASTQ, card against CPU, through
    both finalize routes; then stage-1 checkpoints across card and CPU."""
    from kmc_tpu_torch import Runner, Stage1Params, Stage2Params

    for route, (s, rows) in MID_SPILL.items():
        kw = dict(batch_positions=s, device_store_rows=rows)
        reset_counts()
        _, r2, runner, wall = run_count(fq, WORK / f"mid_spill_{route}_cuda",
                                        "cuda", **kw)
        launches = read_counts()
        _, c2, c_runner, c_wall = run_count(
            fq, WORK / f"mid_spill_{route}_cpu", "cpu", **kw)
        st, c_st = runner.spill_stats, c_runner.spill_stats
        n_comp, c_comp = runner.n_compactions, c_runner.n_compactions
        for other in (f"mid_spill_{route}_cpu", "mid_cuda"):
            if not _same_db(WORK / f"mid_spill_{route}_cuda", WORK / other):
                raise SystemExit(f"phase 11: the {route}-route card DB "
                                 f"differs from {other}")
        if st["n_spills"] < 2 or st["finalize_route"] != route:
            raise SystemExit(f"phase 11: expected >= 2 spills and the "
                             f"{route} route, got {st}")
        counted = [k for k in st if not k.startswith("t_")
                   and k != "merge_launches"]  # the CPU launches no kernel
        if ({k: st[k] for k in counted} != {k: c_st[k] for k in counted}
                or n_comp != c_comp):
            raise SystemExit(f"phase 11: card and CPU spills differ: {st} "
                             f"{c_st}")
        if min(launches.values()) == 0 or (route == "host"
                                           and st["merge_launches"] < 1):
            raise SystemExit(f"phase 11: a kernel never launched: {launches},"
                             f" {st['merge_launches']} in the merges")
        log(f"[phase 11] {route} route (batches {s}, {rows} store rows): "
            f"card DB == CPU DB == phase 4 DB byte for byte; {n_comp} "
            f"compactions, {st['n_spills']} spills of {st['spill_bytes']} "
            f"bytes, {st['n_remerges']} re-merges; spill D2H "
            f"{st['t_spill_d2h']:.3f} s, merge {st['t_host_merge']:.3f} s "
            f"({st['merge_launches']} radix-sort launches); launches "
            f"{launches}; card {wall:.2f} s, cpu {c_wall:.2f} s")

    # checkpoints with spilled runs: card -> CPU and CPU -> card
    s, rows = MID_SPILL["host"]
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        ck = str(WORK / f"ck_{src}")
        r = Runner(device=src)
        r.run_stage1(Stage1Params(input_files=[str(fq)], kmer_len=27,
                                  batch_positions=s, device_store_rows=rows))
        n_runs = len(r._store.spilled)
        r.save_stage1_checkpoint(ck)
        r2 = Runner(device=dst)
        r2.resume_stage1_checkpoint(ck, Stage1Params(
            input_files=[str(fq)], batch_positions=s,
            device_store_rows=rows))
        out = WORK / f"mid_ck_{src}_{dst}"
        r2.run_stage2(Stage2Params(output_file_name=str(out), cutoff_min=2))
        if not _same_db(out, WORK / "mid_cuda"):
            raise SystemExit(f"phase 11: checkpoint {src} -> {dst} differs "
                             "from the straight count")
        log(f"[phase 11] stage-1 checkpoint saved on {src} ({n_runs} spilled"
            f" runs), resumed on {dst}: DB == phase 4 DB byte for byte")


def _host_peak_rss() -> int:
    """The process's peak resident set so far, in bytes (ru_maxrss is in
    KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10


def phase_spill_full():
    """The deployment: a 134 Mbp genome at 10x, about twice the default
    store's rows in unique k-mers, counted under -m 12.  The count runs
    once, under torch.profiler (the device's spans only), for the device's
    idle share; its re-merge and its final merge run on the card, the
    host completer on the host.  Returns the FASTQ, its reads and the
    non-spilling count's DB for phase 13, which deletes them."""
    from kmc_tpu_torch.memory import plan_memory

    fq = WORK / "genome_134M_10x.fastq"
    t0 = time.perf_counter()
    n_reads = write_fastq(fq, 1 << 27, 10, seed=0)
    log(f"[phase 12] wrote {n_reads} reads ({fq.stat().st_size} bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    rss_before = _host_peak_rss()
    # the device's spans only: no store labels and no all-threads host
    # trace over this count's host-bound minutes
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    reset_counts()
    r1, r2, runner, wall = run_count(fq, WORK / "spill_out", "cuda",
                                     profiler=prof, verbose=True)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rss = _host_peak_rss()
    st = runner.spill_stats
    n_comp = runner.n_compactions
    want = n_reads * (150 - 27 + 1)
    if r2.n_total_kmers != want:
        raise SystemExit(f"phase 12: n_total_kmers {r2.n_total_kmers} != "
                         f"{n_reads} reads x 124 = {want}")
    if st["n_spills"] < 1:
        raise SystemExit(f"phase 12: the count never spilled: {st}")
    if min(launches.values()) == 0:
        raise SystemExit(f"phase 12: a kernel never launched: {launches}")
    # each merge sorts at least one key range on the card
    if st["merge_launches"] < st["n_remerges"] + (
            st["finalize_route"] == "host"):
        raise SystemExit(f"phase 12: a merge never sorted on the card: {st}")
    log(f"[phase 12] spilling count: n_total_kmers {r2.n_total_kmers} (= "
        f"{n_reads} x 124), n_unique {r2.n_unique_kmers}, wall_s {wall:.3f} "
        f"stage1_s {r1.time:.3f} stage2_s {r2.time:.3f} finalize_exec_s "
        f"{r2.time_finalize_exec:.3f} compactions {n_comp} spills "
        f"{st['n_spills']} spill_bytes {st['spill_bytes']} spill_d2h_s "
        f"{st['t_spill_d2h']:.3f} remerges {st['n_remerges']} remerge_s "
        f"{st['t_remerge']:.3f} host_merge_s {st['t_host_merge']:.3f} "
        f"(merges on the card: {st['merge_launches']} radix-sort launches) "
        f"route {st['finalize_route']} max_memory_allocated {peak} launches "
        f"{launches} kmers_per_s {r2.n_total_kmers / wall:.0f}")
    plan = plan_memory(12, k=27, batch_positions=1 << 22)
    log(f"[phase 12] host peak RSS (ru_maxrss) {rss} bytes after the count, "
        f"{rss_before} before it; -m 12 budget {plan.budget_bytes} bytes, "
        f"spill budget {plan.spill_budget_bytes} bytes")
    _device_time(prof, "[phase 12]", wall, also=INGEST_KERNELS)
    del prof
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, b2, b_runner, b_wall = run_count(fq, WORK / "spill_ref", "cuda",
                                        device_store_rows=1 << 28)
    b_st, b_comp = b_runner.spill_stats, b_runner.n_compactions
    if b_st["n_spills"]:
        raise SystemExit(f"phase 12: the 2^28-row count spilled: {b_st}")
    if not _same_db(WORK / "spill_out", WORK / "spill_ref"):
        raise SystemExit("phase 12: the spilling count's DB differs from the "
                         "non-spilling count's")
    log(f"[phase 12] non-spilling count (2^28 store rows): DB == spilling "
        f"DB byte for byte; wall_s {b_wall:.3f}, compactions {b_comp}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
    for suf in (".kmc_pre", ".kmc_suf"):
        (WORK / f"spill_out{suf}").unlink()
    torch.cuda.empty_cache()
    return fq, n_reads, WORK / "spill_ref"


def phase_sharded_spill_full(spill):
    """The spilling deployment over 4 shards: phase 12's FASTQ and knobs
    (batches of 2^22, default -m 12, so 2^26 rows a shard), on distinct
    cards where there are several.  The shards spill and re-merge under
    the budget, and each owner merges the spilled rows of its bins on its
    card; the DB must equal phase 12's non-spilling DB byte for byte."""
    fq, n_reads, ref = spill
    devices = shard_devices()
    kind = ("distinct cards" if len(set(devices)) > 1
            else "4 shards on card 0")
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    rss_before = _host_peak_rss()
    reset_counts()
    st, wall = run_sharded(fq, WORK / "spill_sharded", devices,
                           batch_positions=1 << 22,
                           capacity_rows_per_device=None)
    launches = read_counts(SHARDED_PATH)
    peaks = {i: torch.cuda.max_memory_allocated(i)
             for i in range(torch.cuda.device_count())}
    want = n_reads * (150 - 27 + 1)
    if st["n_total"] != want:
        raise SystemExit(f"phase 13: n_total {st['n_total']} != {n_reads} "
                         f"reads x 124 = {want}")
    if st["n_spills"] < 1 or st["merge_launches"] < 1:
        raise SystemExit(f"phase 13: the shards never spilled or the merges "
                         f"never sorted on the card: {st}")
    if not _same_db(WORK / "spill_sharded", ref):
        raise SystemExit("phase 13: the sharded spilling DB differs from "
                         "phase 12's non-spilling DB")
    if min(launches.values()) == 0:
        raise SystemExit(f"phase 13: a kernel never launched: {launches}")
    t = st["timings"]
    log(f"[phase 13] sharded spilling count on {devices} ({kind}): DB == "
        f"phase 12's non-spilling DB byte for byte; n_total {st['n_total']} "
        f"(= {n_reads} x 124), n_unique {st['n_unique']}, wall_s {wall:.3f}, "
        + ", ".join(f"{key} {t[key]:.3f}" for key in (
            "ingest_wall_s", "spill_s", "remerge_s", "owner_hist_s",
            "exchange_groupsort_s", "finalize_exec_s", "finalize_d2h_s",
            "finalize_wall_s"))
        + f" (finalize_exec_s holds the owners' merges), compactions "
        f"{st['n_compactions']}, spills {st['n_spills']}, remerges "
        f"{st['n_remerges']}, radix-sort launches in the merges "
        f"{st['merge_launches']}, max_memory_allocated per card {peaks}, "
        f"launches {launches}, kmers_per_s {st['n_total'] / wall:.0f}")
    log(f"[phase 13] host peak RSS (ru_maxrss) {_host_peak_rss()} bytes after "
        f"the count, {rss_before} before it")
    for path in (fq, *(WORK / f"{name}{suf}" for name in ("spill_sharded",
                                                          "spill_ref")
                       for suf in (".kmc_pre", ".kmc_suf"))):
        path.unlink()
    torch.cuda.empty_cache()


# phase 14's routes at mid size, card against CPU: (name, knobs)
MID_ROUTES = (
    ("kff", dict(output_file_type="KFF")),
    ("w", dict(without_output=True)),
    ("smallk13", dict(kmer_len=13)),
    ("smallk9", dict(kmer_len=9)),
    ("smallk13_kff", dict(kmer_len=13, output_file_type="KFF")),
    ("buckets", dict(device_store=False)),
    ("buckets_kff", dict(device_store=False, output_file_type="KFF")),
    ("opt_out_size", dict(estimate_histogram_cfg="ESTIMATE_AND_COUNT_KMERS")),
    ("kff_replay", dict(output_file_type="KFF",
                        batch_positions=MID_SPILL["replay"][0],
                        device_store_rows=MID_SPILL["replay"][1])),
    ("kff_host", dict(output_file_type="KFF",
                      batch_positions=MID_SPILL["host"][0],
                      device_store_rows=MID_SPILL["host"][1])),
)
ROUTE_KERNELS = ("fused_ingest", "splitter_scan", "radix_sort")


def _route_knobs(kw):
    from kmc_tpu_torch import EstimateHistogramCfg, OutputFileType

    kw = dict(kw)
    if "output_file_type" in kw:
        kw["output_file_type"] = OutputFileType[kw["output_file_type"]]
    if "estimate_histogram_cfg" in kw:
        kw["estimate_histogram_cfg"] = EstimateHistogramCfg[
            kw["estimate_histogram_cfg"]]
    return kw


def _route_launches():
    wrappers = _wrappers()
    return {name: wrappers[name].launches for name in ROUTE_KERNELS}


def _route_uses(kw):
    """The kernels a route must launch: the store's ingest and sort, or the
    host buckets' scan entry and sort; small k and -e launch neither."""
    estimate = getattr(kw.get("estimate_histogram_cfg"), "name", "")
    if kw.get("kmer_len", 27) < 14 or estimate == "ONLY_ESTIMATE":
        return ()
    if kw.get("device_store") is False:
        return ("splitter_scan", "radix_sort")
    return ("fused_ingest", "radix_sort")


def _check_launches(name, kw, launches):
    uses = _route_uses(kw)
    if any((launches[k] > 0) != (k in uses) for k in ROUTE_KERNELS):
        raise SystemExit(f"phase 14: route {name} launched {launches}, "
                         f"it must launch {uses} and no other kernel")


def _no_times(res):
    import dataclasses

    return {k: v for k, v in dataclasses.asdict(res).items()
            if k not in ("time", "time_strict_mem", "time_finalize_exec",
                         "time_finalize_d2h")}


def _route_files(prefix: Path):
    return sorted(p.name[len(prefix.name):]
                  for p in prefix.parent.glob(prefix.name + ".*"))


def _kff_sorted(path):
    """(k-mers as big-endian integers, counts) of a KFF file, in k-mer
    order (k <= 32: a k-mer fits a uint64)."""
    from kmc_tpu_torch.formats.kff import read_kff

    data = read_kff(str(path))
    key = np.zeros(len(data.kmers), np.uint64)
    for j in range(data.kmers.shape[1]):
        key = (key << np.uint64(8)) | data.kmers[:, j]
    order = np.argsort(key, kind="stable")
    return key[order], data.counts[order]


def _cli_estimate(fq, out, device):
    """-e through the port's CLI: the histogram file, as a user runs it."""
    from kmc_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(["-k27", "-e", "-hp", f"-S{1 << 20}", f"--device={device}",
                   str(fq), str(out), str(WORK)])
    if device == "cuda":
        torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"phase 14: kmc_tpu_torch.cli -e on {device} "
                         f"exited {rc}")
    return time.perf_counter() - t0


def phase_other_routes(fq_mid, full):
    """Phase 14: the other routes of one device.  At mid size (phase 4's
    FASTQ) each route's card output against its CPU output, byte for byte,
    and its results apart from times; at full size (phase 5's FASTQ) the
    card's timed runs, held to phase 5's counts."""
    base = dict(batch_positions=1 << 20, device_store_rows=3 << 20)
    for name, knobs in MID_ROUTES:
        kw = dict(base, **_route_knobs(knobs))
        outs = {dev: WORK / f"mid14_{name}_{dev}" for dev in ("cuda", "cpu")}
        reset_counts()
        r1, r2, runner, wall = run_count(fq_mid, outs["cuda"], "cuda", **kw)
        launches = _route_launches()
        c1, c2, c_runner, c_wall = run_count(fq_mid, outs["cpu"], "cpu", **kw)
        if (_no_times(r1), _no_times(r2)) != (_no_times(c1), _no_times(c2)):
            raise SystemExit(f"phase 14: route {name}: card results "
                             f"{r1} {r2} differ from the CPU's {c1} {c2}")
        files = _route_files(outs["cpu"])
        if files != _route_files(outs["cuda"]) or bool(files) == (
                name == "w"):
            raise SystemExit(f"phase 14: route {name} wrote {files} on the "
                             f"CPU, {_route_files(outs['cuda'])} on the card")
        for suf in files:
            if ((outs["cuda"].parent / (outs["cuda"].name + suf)).read_bytes()
                    != (outs["cpu"].parent
                        / (outs["cpu"].name + suf)).read_bytes()):
                raise SystemExit(f"phase 14: route {name}: card and CPU "
                                 f"{suf} differ")
        _check_launches(name, kw, launches)
        route = runner.spill_stats.get("finalize_route")
        if name.startswith("kff_") and route != name[len("kff_"):]:
            raise SystemExit(f"phase 14: route {name} finalized by {route}")
        written = ", ".join(files) or "no files"
        log(f"[phase 14] mid {name}: card == CPU ({written}; results "
            f"equal); n_unique {r2.n_unique_kmers} n_total "
            f"{r2.n_total_kmers}; launches {launches}; card {wall:.2f} s, "
            f"cpu {c_wall:.2f} s")
    hist = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        wall = _cli_estimate(fq_mid, WORK / f"mid14_e_{dev}.hist", dev)
        hist[dev] = (WORK / f"mid14_e_{dev}.hist").read_bytes()
        n_lines = hist[dev].count(b"\n")
        log(f"[phase 14] mid -e (CLI) on {dev}: {wall:.2f} s, {n_lines} "
            f"histogram lines, launches {_route_launches()}")
    if hist["cuda"] != hist["cpu"] or not hist["cuda"]:
        raise SystemExit("phase 14: the -e histogram files differ")

    fq, n_reads, ref = full
    want = (n_reads * (150 - 27 + 1), ref.n_unique_kmers,
            ref.n_below_cutoff_min, ref.n_above_cutoff_max)
    kept = ref.n_unique_kmers - ref.n_below_cutoff_min - ref.n_above_cutoff_max
    full_routes = (
        ("kff", dict(output_file_type="KFF")),
        ("w", dict(without_output=True)),
        ("buckets_kff", dict(device_store=False, output_file_type="KFF")),
        ("opt_out_size",
         dict(estimate_histogram_cfg="ESTIMATE_AND_COUNT_KMERS")),
        ("smallk13", dict(kmer_len=13)),
        ("estimate", dict(estimate_histogram_cfg="ONLY_ESTIMATE")),
    )
    scan_launches = 0
    for name, knobs in full_routes:
        kw = _route_knobs(knobs)
        out = WORK / f"full14_{name}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        r1, r2, runner, wall = run_count(fq, out, "cuda", **kw)
        launches = _route_launches()
        peak = torch.cuda.max_memory_allocated()
        _check_launches(name, kw, launches)
        got = (r2.n_total_kmers, r2.n_unique_kmers, r2.n_below_cutoff_min,
               r2.n_above_cutoff_max)
        if name.startswith("smallk"):
            if r2.n_total_kmers != n_reads * (150 - 13 + 1):
                raise SystemExit(f"phase 14: small-k n_total {got[0]} != "
                                 f"{n_reads} reads x 138")
        elif name == "estimate":
            if sum(r1.estimated_histogram) <= 0:
                raise SystemExit("phase 14: -e estimated nothing")
        elif got != want:
            raise SystemExit(f"phase 14: full {name}: (n_total, n_unique, "
                             f"n_below, n_above) {got} != phase 5's {want}")
        if name == "kff":
            kff_ref = _kff_sorted(out.with_suffix(".kff"))
            if len(kff_ref[0]) != kept:
                raise SystemExit(f"phase 14: the KFF holds {len(kff_ref[0])}"
                                 f" records, phase 5 kept {kept}")
        if name == "buckets_kff":
            scan_launches = launches["splitter_scan"]
            keys, counts = _kff_sorted(out.with_suffix(".kff"))
            if not (np.array_equal(keys, kff_ref[0])
                    and np.array_equal(counts, kff_ref[1])):
                raise SystemExit("phase 14: the host-bucket KFF's (k-mer, "
                                 "count) set differs from the device "
                                 "store's")
        if name == "opt_out_size":
            suf = (out.parent / (out.name + ".kmc_suf")).stat().st_size
            if (suf - 8) % kept or not r1.estimated_histogram:
                raise SystemExit(f"phase 14: the --opt-out-size .kmc_suf of "
                                 f"{suf} bytes does not hold {kept} records")
        log(f"[phase 14] full {name}: (n_total, n_unique, n_below, n_above) "
            f"{got}; wall_s {wall:.3f} stage1_s {r1.time:.3f} stage2_s "
            f"{r2.time:.3f} finalize_exec_s {r2.time_finalize_exec:.3f} "
            f"finalize_d2h_s {r2.time_finalize_d2h:.3f} launches {launches} "
            f"max_memory_allocated {peak}"
            + (f" estimated_histogram[1:4] {r1.estimated_histogram[1:4]}"
               if r1.estimated_histogram else ""))
        for p in out.parent.glob(out.name + ".*"):
            p.unlink()
    return scan_launches


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_member(payload: bytes) -> bytes:
    """One BGZF member: a raw-deflate gzip member whose BC extra field
    holds its size (SAM spec 4.1)."""
    import zlib

    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    return (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + b"\x06\x00BC\x02\x00"
            + struct.pack("<H", len(comp) + 25) + comp
            + struct.pack("<II", zlib.crc32(payload), len(payload)))


def write_bam(path: Path, genome_len: int, coverage: int, seed: int):
    """bench_reads' reads as a BGZF BAM of unmapped records (flag 4, no
    reference), in members of 65,280 bytes compressed on a thread pool:
    the reads of write_fastq with the same arguments, in the same order.
    Fixed-width records (name r + 9 digits) let NumPy build them in
    blocks."""
    from concurrent.futures import ThreadPoolExecutor

    genome, starts = bench_reads(genome_len, coverage, seed)
    name_len, seq_len = 11, 75
    rec_len = 36 + name_len + seq_len + 150
    head = np.frombuffer(struct.pack(
        "<iiiBBHHHiiii", rec_len - 4, -1, -1, name_len, 0, 4680, 0, 4, 150,
        -1, -1, 0), np.uint8)
    nib = np.array([1, 2, 4, 8], np.uint8)
    body = [b"BAM\x01" + struct.pack("<ii", 0, 0)]
    block = 1 << 16
    for lo in range(0, len(starts), block):
        idx = np.arange(lo, min(lo + block, len(starts)))
        rec = np.empty((len(idx), rec_len), np.uint8)
        rec[:, :36] = head
        rec[:, 36] = ord("r")
        for j in range(9):
            rec[:, 37 + j] = 48 + (idx // 10 ** (8 - j)) % 10
        rec[:, 46] = 0
        seq = nib[genome[starts[idx, None] + np.arange(150)[None, :]]]
        rec[:, 47:47 + seq_len] = (seq[:, 0::2] << 4) | seq[:, 1::2]
        rec[:, 47 + seq_len:] = 0xFF
        body.append(rec.tobytes())
    data = b"".join(body)
    step = 65280
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        members = ex.map(_bgzf_member, (data[lo:lo + step]
                                        for lo in range(0, len(data), step)))
        with open(path, "wb") as f:
            for m in members:
                f.write(m)
            f.write(BGZF_EOF)
    return len(starts)


def _db_records(prefix: Path):
    """(k-mers as big-endian uint64, counts) of a KMC database (k <= 32),
    in k-mer order."""
    from kmc_tpu_torch.formats.kmc_db import read_db, sorted_records

    kmers, counts = sorted_records(read_db(str(prefix)))
    key = np.zeros(len(kmers), np.uint64)
    for j in range(kmers.shape[1]):
        key = (key << np.uint64(8)) | kmers[:, j]
    return key, counts


def _input_run(src, out, device, fmt, profiler=None, **kw):
    """run_count over -fbam / -fkmc input; with the launches of the fused
    ingest (and of its packed+mask entry) and of the radix sort, and the
    peak device memory, of the card's run."""
    from kmc_tpu_torch import InputFileType

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r1, r2, runner, wall = run_count(src, out, device, profiler=profiler,
                                     input_file_type=InputFileType(fmt),
                                     **kw)
    launches = dict(read_counts(), mask=_wrappers()["fused_ingest"]
                    .mask_launches)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return r1, r2, wall, launches, peak


def _check_feed(label, fmt, launches):
    """A -fkmc batch takes the packed+mask entry (a separator every
    k_in + 1 codes is too dense for the boundary-delta feed), all but
    perhaps the stream's last batch, whose few records before the padding
    may fit the delta list; a -fbam run of 150 bp reads takes the
    boundary entry only."""
    n, mask = launches["fused_ingest"], launches["mask"]
    if n == 0 or launches["radix_sort"] == 0:
        raise SystemExit(f"phase 15: {label}: a kernel never launched: "
                         f"{launches}")
    if not (n - 1 <= mask <= n if fmt == "kmc" else mask == 0):
        raise SystemExit(f"phase 15: {label}: {mask} packed+mask launches "
                         f"of {n}")


def _host_parse_s(fmt, src):
    """Seconds of the host's input work alone: BAM inflate and parse, or
    read_db and the decode of -fkmc, over the whole input."""
    from kmc_tpu_torch.io.readers import ParseState
    from kmc_tpu_torch.runner import bam_chunks, kmc_db_code_chunks, n_cpus

    t0 = time.perf_counter()
    if fmt == "bam":
        chunks = bam_chunks([str(src)], ParseState(), both_strands=True,
                            n_threads=n_cpus())
    else:
        chunks = kmc_db_code_chunks([str(src)], ParseState())
    n = sum(len(c) for c in chunks)
    return time.perf_counter() - t0, n


def phase_inputs_mid(fq_mid):
    """Phase 15's mid-size half: -fbam and -fkmc, card against CPU."""
    from kmc_tpu_torch import distributed_count

    bam = WORK / "mid.bam"
    write_bam(bam, 1 << 20, 10, seed=1)  # phase 4's reads
    base = dict(batch_positions=1 << 20, device_store_rows=3 << 20)
    runs = (  # (name, input, format, knobs, the DB it must also equal)
        ("fbam", bam, "bam", {}, "mid_cuda"),
        ("fkmc_k27", WORK / "mid_cuda", "kmc", dict(cutoff_min=1), None),
        ("fkmc_k21", WORK / "mid_cuda", "kmc",
         dict(kmer_len=21, cutoff_min=1), None),
        ("kmc1_k13", fq_mid, "fastq", dict(kmer_len=13, cutoff_min=1),
         None),
        ("fkmc_kmc1_k9", WORK / "mid15_kmc1_k13_cuda", "kmc",
         dict(kmer_len=9, cutoff_min=1), None),
    )
    for name, src, fmt, knobs, also in runs:
        outs = {dev: WORK / f"mid15_{name}_{dev}" for dev in ("cuda", "cpu")}
        kw = dict(base, **knobs)
        r1, r2, wall, launches, _ = _input_run(src, outs["cuda"], "cuda",
                                               fmt, **kw)
        c1, c2, c_wall, _, _ = _input_run(src, outs["cpu"], "cpu", fmt, **kw)
        if (_no_times(r1), _no_times(r2)) != (_no_times(c1), _no_times(c2)):
            raise SystemExit(f"phase 15: mid {name}: card results {r1} {r2} "
                             f"differ from the CPU's {c1} {c2}")
        for other in ["cpu"] + ([also] if also else []):
            path = outs["cpu"] if other == "cpu" else WORK / other
            if not _same_db(outs["cuda"], path):
                raise SystemExit(f"phase 15: mid {name}: the card DB "
                                 f"differs from {path.name}")
        if kw.get("kmer_len", 27) >= 14:
            _check_feed(f"mid {name}", fmt, launches)
        log(f"[phase 15] mid {name}: card DB == CPU DB"
            + (f" == {also} DB" if also else "") + f" byte for byte; "
            f"n_reads {r1.n_sequences} n_total {r2.n_total_kmers} n_unique "
            f"{r2.n_unique_kmers}; launches {launches}; card {wall:.2f} s, "
            f"cpu {c_wall:.2f} s")
    for name, src, fmt, k, single in (
            ("fbam", bam, "bam", 27, "mid_cuda"),
            ("fkmc_k21", WORK / "mid_cuda", "kmc", 21,
             "mid15_fkmc_k21_cuda")):
        reset_counts()
        t0 = time.perf_counter()
        st = distributed_count([str(src)], str(WORK / f"mid15_d2_{name}"),
                               k=k, cutoff_min=2 if fmt == "bam" else 1,
                               devices=["cuda:0"] * 2,
                               batch_positions=1 << 18,
                               capacity_rows_per_device=3 << 19,
                               input_file_type=fmt)
        _sync_all()
        wall = time.perf_counter() - t0
        launches = dict(read_counts(SHARDED_PATH),
                        mask=_wrappers()["fused_ingest"].mask_launches)
        if not _same_db(WORK / f"mid15_d2_{name}", WORK / single):
            raise SystemExit(f"phase 15: the sharded {name} DB differs from "
                             f"the single-device {single}")
        _check_feed(f"sharded {name}", fmt, launches)
        if launches["ragged_all_to_all"] == 0:
            raise SystemExit(f"phase 15: sharded {name}: the exchange never "
                             f"launched: {launches}")
        log(f"[phase 15] mid sharded {name}, 2 shards on cuda:0: DB == "
            f"{single} DB byte for byte; n_total {st['n_total']}; launches "
            f"{launches}; {wall:.2f} s")


def phase_inputs_full(full):
    """Phase 15's full-size half: -fbam over phase 5's reads, -fkmc from
    phase 5's database, timed on the card and held to phase 5's counts."""
    fq, n_reads, ref = full
    db5 = WORK / "bench_out"
    bam = WORK / "bench.bam"
    t0 = time.perf_counter()
    write_bam(bam, 1 << 23, 30, seed=0)
    log(f"[phase 15] wrote {bam.name}: {n_reads} reads, "
        f"{bam.stat().st_size} bytes, in {time.perf_counter() - t0:.1f} s")
    keys5, counts5 = _db_records(db5)
    n_rec = len(keys5)
    runs = (  # (name, input, format, knobs, (n_total, n_unique) or None)
        ("fbam", bam, "bam", {}, (n_reads * (150 - 27 + 1),
                                   ref.n_unique_kmers)),
        ("fkmc_k21", db5, "kmc", dict(kmer_len=21, cutoff_min=1),
         (n_rec * (27 - 21 + 1), None)),
        ("fkmc_k27", db5, "kmc", dict(cutoff_min=1), (n_rec, n_rec)),
    )
    for name, src, fmt, knobs, want in runs:
        parse_s, n_codes = _host_parse_s(fmt, src)
        out = WORK / f"full15_{name}"
        prof = device_profiler() if name == "fkmc_k27" else None
        with labelled_store() if prof else contextlib.nullcontext():
            r1, r2, wall, launches, peak = _input_run(src, out, "cuda", fmt,
                                                      profiler=prof, **knobs)
        _check_feed(f"full {name}", fmt, launches)
        got = (r2.n_total_kmers, r2.n_unique_kmers)
        if got[0] != want[0] or (want[1] is not None and got[1] != want[1]):
            raise SystemExit(f"phase 15: full {name}: (n_total, n_unique) "
                             f"{got}, expected {want}")
        if name == "fbam" and not _same_db(out, db5):
            raise SystemExit("phase 15: the full-size -fbam DB differs from "
                             "phase 5's")
        if name == "fkmc_k27":
            keys, counts = _db_records(out)
            if not np.array_equal(keys, keys5) or (counts != 1).any():
                raise SystemExit("phase 15: -fkmc at k = k_in did not give "
                                 "back phase 5's k-mers, each once")
        log(f"[phase 15] full {name}: n_reads {r1.n_sequences} (n_total, "
            f"n_unique) {got}" + (" DB == phase 5 DB byte for byte"
                                  if name == "fbam" else "")
            + f"; wall_s {wall:.3f} stage1_s {r1.time:.3f} stage2_s "
            f"{r2.time:.3f} finalize_exec_s {r2.time_finalize_exec:.3f}; "
            f"host parse alone {parse_s:.3f} s ({n_codes} codes); launches "
            f"{launches}; max_memory_allocated {peak}")
        if prof is not None:
            _device_time(prof, f"[phase 15] full {name}", wall,
                         also=INGEST_KERNELS)
        for p in out.parent.glob(out.name + ".*"):
            p.unlink()
    bam.unlink()
    return keys5, counts5


def phase_readers(full, records):
    """Phase 15's readers on phase 5's database: read_db, kmc_dump, the
    listing and the random-access API, each timed and held to the
    database's own records."""
    from kmc_tpu_torch import dump_cli
    from kmc_tpu_torch.api import KMCFile, KmerAPI
    from kmc_tpu_torch.formats.dump import dump_db_file
    from kmc_tpu_torch.formats.kmc_db import read_db
    from kmc_tpu_torch.tools import native_tools

    fq, n_reads, ref = full
    keys5, counts5 = records
    db5 = str(WORK / "bench_out")
    t0 = time.perf_counter()
    db = read_db(db5)
    t_read = time.perf_counter() - t0
    log(f"[phase 15] read_db: {db.n_records} records in {t_read:.3f} s")

    dumped = []
    run_dump = native_tools.run_dump

    def counted(*args, **kw):
        dumped.append(run_dump(*args, **kw))
        return dumped[-1]

    out = WORK / "full15.dump"
    native_tools.run_dump = counted
    try:
        t0 = time.perf_counter()
        rc = dump_cli.main([db5, str(out)])
        t_dump = time.perf_counter() - t0
    finally:
        native_tools.run_dump = run_dump
    if rc != 0 or dumped != [db.n_records]:
        raise SystemExit(f"phase 15: kmc_dump exited {rc}, native dump "
                         f"{dumped}")
    t0 = time.perf_counter()
    text = dump_db_file(db5, sorted_output=False)
    t_text = time.perf_counter() - t0
    if out.read_text() != text:
        raise SystemExit("phase 15: kmc_dump's file differs from "
                         "dump_db_file's")
    log(f"[phase 15] kmc_dump (native, listing order): {out.stat().st_size} "
        f"bytes in {t_dump:.3f} s == dump_db_file (NumPy) in {t_text:.3f} s")
    out.unlink()
    del text

    # the listing's and the read lookups' depths keep the script near half
    # its time limit: both are timed per call of the API's Python
    n_list = 2 * 10 ** 5
    f = KMCFile()
    t0 = time.perf_counter()
    if not f.OpenForListing(db5):
        raise SystemExit("phase 15: OpenForListing failed")
    km = KmerAPI()
    codes, got_c = [], np.zeros(n_list, np.uint32)
    for i in range(n_list):
        ok, got_c[i] = f.ReadNextKmer(km)
        if not ok:
            raise SystemExit(f"phase 15: the listing stopped at {i}")
        codes.append(km.codes.copy())
    t_list = time.perf_counter() - t0
    f.Close()
    got = np.zeros(n_list, np.uint64)
    for col in np.stack(codes).T.astype(np.uint64):
        got = (got << np.uint64(2)) | col
    if not (np.array_equal(got, keys5[:n_list])
            and np.array_equal(got_c, counts5[:n_list])):
        raise SystemExit(f"phase 15: the listing's first {n_list} k-mers "
                         "differ from sorted_records'")
    log(f"[phase 15] OpenForListing + {n_list} ReadNextKmer in "
        f"{t_list:.3f} s, in order, == sorted_records")

    # n_ra sampled reads: every window's count through the API, and from
    # the records by a search of the canonical 27-mer's key; 10^4 sampled
    # records through CheckKmer
    n_ra = 2 * 10 ** 4
    genome, starts = bench_reads(1 << 23, 30, seed=0)
    rng = np.random.default_rng(15)
    pick = starts[rng.choice(len(starts), n_ra, replace=False)]
    codes = genome[pick[:, None] + np.arange(150)[None, :]].astype(np.uint64)
    fwd = np.zeros((len(pick), 124), np.uint64)
    rev = np.zeros_like(fwd)
    for j in range(27):
        fwd = (fwd << np.uint64(2)) | codes[:, j:j + 124]
        rev |= (np.uint64(3) - codes[:, j:j + 124]) << np.uint64(2 * j)
    canon = np.minimum(fwd, rev)
    pos = np.searchsorted(keys5, canon).clip(max=len(keys5) - 1)
    want = np.where(keys5[pos] == canon, counts5[pos], 0).astype(np.int64)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    chars = acgt[codes.astype(np.int64)]
    reads = [row.tobytes() for row in chars]
    sample = rng.choice(len(keys5), 10 ** 4, replace=False)
    shifts = np.arange(52, -2, -2, dtype=np.uint64)
    chars = acgt[((keys5[sample, None] >> shifts[None, :])
                  & np.uint64(3)).astype(np.int64)]
    queries = [row.tobytes().decode() for row in chars]
    for mode, threshold in (("in memory", None), ("on disk", "0")):
        if threshold is None:
            os.environ.pop("KMC_TPU_RA_THRESHOLD", None)
        else:
            os.environ["KMC_TPU_RA_THRESHOLD"] = threshold
        f = KMCFile()
        t0 = time.perf_counter()
        if not f.OpenForRA(db5) or f._is_file_ra() != (threshold == "0"):
            raise SystemExit(f"phase 15: OpenForRA ({mode}) failed")
        t_open = time.perf_counter() - t0
        t0 = time.perf_counter()
        hits = [f.CheckKmer(q) for q in queries]
        t_check = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_read = np.array([f.GetCountersForRead(r)[1] for r in reads],
                            np.int64)
        t_reads = time.perf_counter() - t0
        if hits != [(True, int(c)) for c in counts5[sample]]:
            raise SystemExit(f"phase 15: CheckKmer ({mode}) disagrees with "
                             "the records")
        if not np.array_equal(per_read, want):
            raise SystemExit(f"phase 15: GetCountersForRead ({mode}) "
                             "disagrees with the records")
        log(f"[phase 15] OpenForRA {mode}: open {t_open:.3f} s, 10^4 "
            f"CheckKmer {t_check:.3f} s, {n_ra} reads' counters "
            f"{t_reads:.3f} s, == the records")
    os.environ.pop("KMC_TPU_RA_THRESHOLD", None)


def phase_inputs_and_readers(fq_mid, full):
    """Phase 15: BAM and KMC-database input, and the database readers."""
    phase_inputs_mid(fq_mid)
    records = phase_inputs_full(full)
    phase_readers(full, records)


def _head_fastq(src: Path, dst: Path, n_reads: int) -> int:
    """The first n_reads records of a FASTQ (four lines each) into dst."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        for i, line in enumerate(f):
            if i == 4 * n_reads:
                break
            g.write(line)
    return n_reads


# the child reports its peak RSS: VmHWM where /proc has it, else
# ru_maxrss.  It runs under sh, which forks it, so its ru_maxrss does not
# start from the (large) peak of this process, as an exec would keep it.
_TOOLS_CHILD = (
    "import re, resource, sys\n"
    "from kmc_tpu_torch.tools_cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "sys.stdout.flush()\n"
    "hwm = re.search(r'VmHWM:\\s*(\\d+)', open('/proc/self/status').read())\n"
    "kib = int(hwm.group(1)) if hwm else resource.getrusage("
    "resource.RUSAGE_SELF).ru_maxrss\n"
    "sys.stderr.write('PEAK_RSS %d\\n' % (1024 * kib))\n"
    "sys.exit(rc)\n")


def _tools_main(argv, out_file=None):
    """kmc_tools as its users run it: `python -m kmc_tpu_torch.tools_cli`
    in a process of its own (the environment's KMC_TPU_* knobs pass on),
    standard output into out_file when given.  Returns (exit code, the
    process's peak RSS in bytes)."""
    with (open(out_file, "w") if out_file else contextlib.nullcontext()) \
            as f:
        r = subprocess.run(["sh", "-c", '"$@"; exit $?', "sh",
                            sys.executable, "-c", _TOOLS_CHILD]
                           + [str(a) for a in argv], cwd=ROOT,
                           stdout=f if f else subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True, timeout=900)
    peak = re.findall(r"PEAK_RSS (\d+)", r.stderr)
    if not peak:
        raise SystemExit(f"phase 16: kmc_tools {argv[0]} died: {r.stderr}")
    return r.returncode, int(peak[-1])


SIMPLE_OPS = ("intersect", "union", "kmers_subtract", "counters_subtract",
              "reverse_kmers_subtract", "reverse_counters_subtract")


def run_tools(a: Path, b: Path, reads: Path, d: Path, kmer: str) -> dict:
    """Every kmc_tools operation of phase 16 on databases a and b into
    directory d, each in a process of its own (_tools_main), timed: info,
    check, the five transforms, the six simple operations in one pass (KMC1
    outputs, then KFF), a complex file, compare a a and a b, and filter of
    `reads` against a.  Returns {operation: (seconds, peak RSS bytes)}."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "ops.def").write_text(
        f"INPUT:\na = {a} -ci3\nb = {b}\nOUTPUT:\n{d / 'cx'} = "
        "(a *max b) + (a - b)\nOUTPUT_PARAMS:\n-cs1000\n")
    runs = [
        ("info", ["info", a], d / "info.txt", 0),
        ("check", ["check", a, kmer], d / "check.txt", 0),
        ("histogram", ["transform", a, "histogram", d / "hist.txt"], None, 0),
        ("dump -s", ["transform", a, "dump", "-s", d / "dump.txt"], None, 0),
        ("reduce -ci3", ["transform", a, "reduce", d / "red", "-ci3"],
         None, 0),
        ("compact", ["transform", a, "compact", d / "cmp"], None, 0),
        ("set_counts", ["transform", a, "set_counts", "7", d / "sc"], None,
         0),
        ("simple x6", ["simple", a, b] + [x for op in SIMPLE_OPS
                                          for x in (op, d / op)], None, 0),
        ("simple x6 -okff", ["simple", a, b] + [
            x for op in SIMPLE_OPS for x in (op, d / f"{op}_kff", "-okff")],
         None, 0),
        ("complex", ["complex", d / "ops.def"], None, 0),
        ("compare a a", ["compare", a, a], None, 0),
        ("compare a b", ["compare", a, b], None, 1),
        ("filter", ["filter", a, reads, "-ci0.5", d / "filtered.fq"], None,
         0),
    ]
    secs = {}
    for name, argv, out_file, want_rc in runs:
        t0 = time.perf_counter()
        rc, peak = _tools_main(argv, out_file)
        secs[name] = (time.perf_counter() - t0, peak)
        if rc != want_rc:
            raise SystemExit(f"phase 16: kmc_tools {name} exited {rc}, "
                             f"expected {want_rc}")
    return secs


def _secs_json(secs) -> str:
    """{operation: [seconds, peak RSS bytes]} for the log."""
    return json.dumps({k: [round(t, 3), rss] for k, (t, rss) in
                       secs.items()})


def _kmer_of(key: int, k: int) -> str:
    return "".join("ACGT"[(key >> (2 * (k - 1 - i))) & 3] for i in range(k))


def phase_tools(full):
    """Phase 16: kmc_tools at full size (phase 5's DB, A, and a count of
    the first quarter of phase 5's reads at its knobs, B): the native
    route timed, with the host's peak RSS, and held to the set identities
    of sorted_records and, for union and histogram, to the NumPy route's
    bytes.  The tools load no torch; their three routes are held byte for
    byte against kmc_tpu's on the CPU by tests/test_torch_tools.py and
    tests/test_torch_tools_native.py, so the card run repeats none of
    that."""
    from kmc_tpu_torch.tools import native_tools

    fq5, n_reads, ref = full
    t0 = time.perf_counter()
    native_tools.get_lib()
    log(f"[phase 16] native streaming core built / loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    # full size: A = phase 5's DB, B = its first quarter of reads
    a, b = WORK / "bench_out", WORK / "bench_q1"
    q1 = WORK / "bench_q1.fastq"
    n_q1 = _head_fastq(fq5, q1, n_reads // 4)
    _, rb, _, wall_b = run_count(q1, b, "cuda")
    q1.unlink()
    reads = WORK / "bench_reads_1e5.fastq"
    _head_fastq(fq5, reads, 10 ** 5)
    keys_a, cnt_a = _db_records(a)
    keys_b, cnt_b = _db_records(b)
    log(f"[phase 16] A: phase 5's DB, {len(keys_a)} records; B: {n_q1} "
        f"reads counted in {wall_b:.3f} s, {len(keys_b)} records")
    d = WORK / "tools_full"
    secs = run_tools(a, b, reads, d, _kmer_of(int(keys_a[12345]), 27))
    # set identities
    rec = {op: _db_records(d / op) for op in ("union", "intersect",
                                               "kmers_subtract")}
    n_u, n_i, n_s = (len(rec[op][0]) for op in ("union", "intersect",
                                                 "kmers_subtract"))
    if n_u + n_i != len(keys_a) + len(keys_b):
        raise SystemExit(f"phase 16: |A u B| + |A n B| = {n_u} + {n_i} != "
                         f"|A| + |B| = {len(keys_a)} + {len(keys_b)}")
    if n_s != len(keys_a) - n_i:
        raise SystemExit(f"phase 16: |A - B| = {n_s} != |A| - |A n B|")
    ku, cu = rec["union"]
    ia = np.searchsorted(keys_a, ku).clip(max=len(keys_a) - 1)
    ib = np.searchsorted(keys_b, ku).clip(max=len(keys_b) - 1)
    sums = (np.where(keys_a[ia] == ku, cnt_a[ia], 0).astype(np.int64)
            + np.where(keys_b[ib] == ku, cnt_b[ib], 0))
    if not np.array_equal(cu.astype(np.int64), np.minimum(sums, 255)):
        raise SystemExit("phase 16: union counters are not the sums capped "
                         "at counter_max 255")
    hist = np.loadtxt(d / "hist.txt", dtype=np.int64, ndmin=2)
    if int(hist[:, 1].sum()) != len(keys_a):
        raise SystemExit(f"phase 16: the histogram holds "
                         f"{int(hist[:, 1].sum())} records, A {len(keys_a)}")
    # the NumPy route for union and histogram, byte for byte
    os.environ["KMC_TPU_NATIVE_TOOLS"] = "0"
    try:
        t0 = time.perf_counter()
        rc_u, _ = _tools_main(["simple", a, b, "union", d / "union_np"])
        t_union_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc_h, _ = _tools_main(["transform", a, "histogram",
                               d / "hist_np.txt"])
        t_hist_np = time.perf_counter() - t0
        if rc_u or rc_h:
            raise SystemExit("phase 16: a NumPy-route tool failed")
    finally:
        os.environ.pop("KMC_TPU_NATIVE_TOOLS", None)
    for x, y in (("union.kmc_pre", "union_np.kmc_pre"),
                 ("union.kmc_suf", "union_np.kmc_suf"),
                 ("hist.txt", "hist_np.txt")):
        if (d / x).read_bytes() != (d / y).read_bytes():
            raise SystemExit(f"phase 16: {y} (NumPy route) differs from {x}")
    log(f"[phase 16] full size, native route, [seconds, peak RSS bytes] "
        f"of each tool's process: " + _secs_json(secs) + f"; "
        f"|A u B| {n_u} |A n B| {n_i} "
        f"|A - B| {n_s}: the set identities hold, union counters = sums "
        f"capped at 255, histogram total = |A|; NumPy route union "
        f"{t_union_np:.3f} s and histogram {t_hist_np:.3f} s, byte for byte "
        "== native")
    for p in list(d.iterdir()) + [reads]:
        p.unlink()
    return secs


def _greedy_env(mode: str):
    os.environ["KMC_TPU_GREEDY_DEFER"] = "1" if mode == "deferred" else "0"


def _greedy_launches():
    w = _wrappers()
    return dict(fused_ingest=w["fused_ingest"].launches,
                greedy=w["fused_ingest"].greedy_launches,
                hist=w["fused_ingest"].hist_launches,
                splitter_scan=w["splitter_scan"].launches,
                radix_sort=w["radix_sort"].launches)


def _check_greedy_launches(label, mode, launches, collect, s):
    """Deferred: every batch on the prefix entry, the first
    ceil(2^27 / s) with the histogram, the collect's one radix sort; no
    scan entry.  Eager: the scan entry's stage 0, every batch on the
    greedy entry, no histogram."""
    n = launches["fused_ingest"]
    if mode == "deferred":
        ok = (launches["greedy"] == 0 and launches["splitter_scan"] == 0
              and launches["hist"] == min(n, -(-(1 << 27) // s))
              and collect == 1)
    else:
        ok = (launches["greedy"] == n and launches["hist"] == 0
              and launches["splitter_scan"] > 0 and collect == 0)
    if n == 0 or launches["radix_sort"] == 0 or not ok:
        raise SystemExit(f"phase 17: {label}: launches {launches}, collect "
                         f"{collect}")


def phase_greedy(fq_mid, full):
    """Phase 17: the greedy signature map of the device store.  Mid size
    (phase 4's FASTQ): card == CPU byte for byte, deferred and eager, and
    deferred == eager; both spill routes (phase 11's stores) == the
    non-spilling DB; a deferred greedy checkpoint card -> CPU and CPU ->
    card == the straight count.  Full size (phase 5's FASTQ and knobs),
    deferred and eager, timed: n_total = n_reads x 124, the (k-mer, count)
    set == phase 5's, the .kmc_pre footer holds the greedy map, the
    launches of each mode; then the deferred run under torch.profiler."""
    from kmc_tpu_torch import Runner, Stage1Params, Stage2Params
    from kmc_tpu_torch.formats.kmc_db import read_pre_meta

    base = dict(batch_positions=1 << 20, device_store_rows=3 << 20,
                signature_map_policy="greedy")
    try:
        for mode in ("deferred", "eager"):
            _greedy_env(mode)
            reset_counts()
            _, r2, runner, wall = run_count(fq_mid, WORK / f"mid17_{mode}",
                                            "cuda", **base)
            launches = _greedy_launches()
            _check_greedy_launches(f"mid {mode}", mode, launches,
                                   runner.spill_stats["collect_launches"],
                                   base["batch_positions"])
            _, c2, _, c_wall = run_count(fq_mid, WORK / f"mid17_{mode}_cpu",
                                         "cpu", **base)
            if not _same_db(WORK / f"mid17_{mode}",
                            WORK / f"mid17_{mode}_cpu"):
                raise SystemExit(f"phase 17: mid {mode}: card DB != CPU DB")
            if _no_times(r2) != _no_times(c2):
                raise SystemExit(f"phase 17: mid {mode}: card results {r2} "
                                 f"differ from the CPU's {c2}")
            for route, (s, rows) in MID_SPILL.items():
                _, _, sp, _ = run_count(
                    fq_mid, WORK / f"mid17_{mode}_{route}", "cuda",
                    **dict(base, batch_positions=s, device_store_rows=rows))
                st = sp.spill_stats
                if (st["finalize_route"] != route or st["n_spills"] < 2
                        or not _same_db(WORK / f"mid17_{mode}_{route}",
                                        WORK / f"mid17_{mode}")):
                    raise SystemExit(f"phase 17: mid {mode} {route} route: "
                                     f"{st}, or its DB differs")
            log(f"[phase 17] mid {mode}: card DB == CPU DB byte for byte "
                f"({runner._n_used_bins} greedy bins); the replay and host "
                f"spill routes == it; launches {launches}; card {wall:.2f} "
                f"s, cpu {c_wall:.2f} s")
        if not _same_db(WORK / "mid17_deferred", WORK / "mid17_eager"):
            raise SystemExit("phase 17: mid deferred DB != eager DB")
        _greedy_env("deferred")
        s, rows = MID_SPILL["host"]
        for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
            ck = str(WORK / f"ck17_{src}")
            r = Runner(device=src)
            r.run_stage1(Stage1Params(input_files=[str(fq_mid)], kmer_len=27,
                                      batch_positions=s,
                                      device_store_rows=rows,
                                      signature_map_policy="greedy"))
            n_runs = len(r._store.spilled)
            r.save_stage1_checkpoint(ck)
            r2 = Runner(device=dst)
            r2.resume_stage1_checkpoint(ck, Stage1Params(
                input_files=[str(fq_mid)], batch_positions=s,
                device_store_rows=rows))
            out = WORK / f"mid17_ck_{src}_{dst}"
            r2.run_stage2(Stage2Params(output_file_name=str(out),
                                       cutoff_min=2))
            if not _same_db(out, WORK / "mid17_deferred"):
                raise SystemExit(f"phase 17: greedy checkpoint {src} -> "
                                 f"{dst} differs from the straight count")
            log(f"[phase 17] deferred greedy checkpoint saved on {src} "
                f"({n_runs} spilled runs), resumed on {dst}: DB == the "
                "straight count's byte for byte")

        fq5, n_reads, ref = full
        keys5, counts5 = _db_records(WORK / "bench_out")
        prefix_map = read_pre_meta(str(WORK / "bench_out"))[2]
        s5 = 1 << 22
        for mode in ("deferred", "eager"):
            _greedy_env(mode)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out = WORK / f"full17_{mode}"
            r1, r2, runner, wall = run_count(fq5, out, "cuda", verbose=True,
                                             signature_map_policy="greedy")
            launches = _greedy_launches()
            peak = torch.cuda.max_memory_allocated()
            _check_greedy_launches(f"full {mode}", mode, launches,
                                   runner.spill_stats["collect_launches"], s5)
            if r2.n_total_kmers != n_reads * (150 - 27 + 1):
                raise SystemExit(f"phase 17: full {mode}: n_total "
                                 f"{r2.n_total_kmers} != n_reads x 124")
            keys, counts = _db_records(out)
            if not (np.array_equal(keys, keys5)
                    and np.array_equal(counts, counts5)):
                raise SystemExit(f"phase 17: full {mode}: the (k-mer, count) "
                                 "set differs from phase 5's")
            footer = read_pre_meta(str(out))[2]
            if (not np.array_equal(footer, runner._sig_map)
                    or np.array_equal(footer, prefix_map)):
                raise SystemExit(f"phase 17: full {mode}: the .kmc_pre "
                                 "footer does not hold the greedy map")
            log(f"[phase 17] full {mode}: n_total {r2.n_total_kmers} (= "
                f"{n_reads} x 124), n_unique {r2.n_unique_kmers}, (k-mer, "
                f"count) set == phase 5's, footer == the greedy map of "
                f"{runner._n_used_bins} bins; wall_s {wall:.3f} stage1_s "
                f"{r1.time:.3f} stage2_s {r2.time:.3f} finalize_exec_s "
                f"{r2.time_finalize_exec:.3f} finalize_d2h_s "
                f"{r2.time_finalize_d2h:.3f}; launches {launches}, collect "
                f"{runner.spill_stats['collect_launches']}; "
                f"max_memory_allocated {peak}")
            if mode == "deferred":
                result = dict(launches=launches, wall=wall)
                result["collect"] = runner.spill_stats["collect_launches"]
            else:
                result["eager_greedy"] = launches["greedy"]
            for p in out.parent.glob(out.name + ".*"):
                p.unlink()
        _greedy_env("deferred")
        prof = device_profiler()
        with labelled_store():
            _, _, _, wall = run_count(fq5, WORK / "full17_prof", "cuda",
                                      profiler=prof,
                                      signature_map_policy="greedy")
        _device_time(prof, "[phase 17] full deferred", wall,
                     also=INGEST_KERNELS + SORT_KERNELS)
        for p in WORK.glob("full17_prof.*"):
            p.unlink()
    finally:
        os.environ.pop("KMC_TPU_GREEDY_DEFER", None)
    return result


# phase 18: the sharded count's other modes over 4 shards, and the SPMD
# count step.  (name, distributed_count knobs); k = 27 and -ci2 unless set
SHARDED_MODES_MID = (
    ("smallk13", dict(k=13)),
    ("smallk13_kff", dict(k=13, output_type="kff")),
    ("greedy27", dict(signature_map_policy="greedy")),
    ("greedy32", dict(k=32, signature_map_policy="greedy")),
    ("kff", dict(output_type="kff")),
    ("estimate", dict(estimate_only=True)),
    ("opt_out_size", dict(opt_out_size=True)),
    # phase 8's spilling shards of 2^19 rows
    ("greedy27_spill", dict(signature_map_policy="greedy",
                            capacity_rows_per_device=1 << 19)),
    ("kff_spill", dict(output_type="kff", capacity_rows_per_device=1 << 19)),
)
SHARDED_MODES_FULL = (
    ("greedy27", dict(signature_map_policy="greedy")),
    ("kff", dict(output_type="kff")),
    ("opt_out_size", dict(opt_out_size=True)),
    ("smallk13", dict(k=13)),
    ("estimate", dict(estimate_only=True)),
)
# the kernels whose launches phase 18 reads
MODE_KERNELS = ("fused_ingest", "greedy", "splitter_scan", "radix_sort",
                "ragged_all_to_all")


def _mode_launches():
    w = _wrappers()
    out = {name: w[name].launches for name in MODE_KERNELS
           if name != "greedy"}
    out["greedy"] = w["fused_ingest"].greedy_launches
    return out


def _mode_uses(knobs):
    """The kernels a sharded mode must launch, and no other of
    MODE_KERNELS: small k and -e none; the store's routes the fused ingest,
    the sort and the ragged exchange; greedy also the scan entry (stage 0)
    and the greedy entry for every batch."""
    if knobs.get("estimate_only") or knobs.get("k", 27) < 14:
        return ()
    uses = ("fused_ingest", "radix_sort", "ragged_all_to_all")
    if knobs.get("signature_map_policy") == "greedy":
        uses += ("greedy", "splitter_scan")
    return uses


def _check_mode_launches(label, knobs, launches):
    uses = _mode_uses(knobs)
    if any((launches[k] > 0) != (k in uses) for k in MODE_KERNELS) or (
            "greedy" in uses
            and launches["greedy"] != launches["fused_ingest"]):
        raise SystemExit(f"phase 18: {label} launched {launches}, it must "
                         f"launch {uses} (greedy on every ingest) and no "
                         "other kernel")


def _no_timing_stats(st):
    # merge_launches counts kernel launches: none on the CPU
    return {k: v for k, v in st.items()
            if k not in ("timings", "merge_launches")}


def _mode_records(prefix: Path, knobs):
    """(k-mer keys, counts) of a mode's output, in k-mer order."""
    if knobs.get("output_type") == "kff":
        return _kff_sorted(prefix.parent / (prefix.name + ".kff"))
    return _db_records(prefix)


def _same_records(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def phase_sharded_modes_mid(fq_mid, devices):
    """Phase 18 at mid size: each mode over 4 card shards against 4 CPU
    shards, every file byte for byte and the stats; greedy and KFF at
    k = 27 also against phase 4's single-device card count's records."""
    base = dict(batch_positions=1 << 18, capacity_rows_per_device=3 << 19)
    ref4 = _db_records(WORK / "mid_cuda")
    launches_all = {}
    for name, knobs in SHARDED_MODES_MID:
        outs = {dev: WORK / f"mid18_{name}_{dev}" for dev in ("cuda", "cpu")}
        reset_counts()
        kw = dict(base, **knobs)
        st, wall = run_sharded(fq_mid, outs["cuda"], devices, **kw)
        launches = _mode_launches()
        c_st, c_wall = run_sharded(fq_mid, outs["cpu"], ["cpu"] * 4, **kw)
        if _no_timing_stats(st) != _no_timing_stats(c_st):
            raise SystemExit(f"phase 18: mid {name}: card stats "
                             f"{_no_timing_stats(st)} != CPU stats "
                             f"{_no_timing_stats(c_st)}")
        files = _route_files(outs["cpu"])
        if files != _route_files(outs["cuda"]) or bool(files) == (
                name == "estimate"):
            raise SystemExit(f"phase 18: mid {name} wrote {files} on the "
                             f"CPU, {_route_files(outs['cuda'])} on the card")
        for suf in files:
            if ((outs["cuda"].parent / (outs["cuda"].name + suf)).read_bytes()
                    != (outs["cpu"].parent
                        / (outs["cpu"].name + suf)).read_bytes()):
                raise SystemExit(f"phase 18: mid {name}: card and CPU {suf} "
                                 "differ")
        _check_mode_launches(f"mid {name}", knobs, launches)
        if name.endswith("spill") and st["n_spills"] < 1:
            raise SystemExit(f"phase 18: mid {name} never spilled: {st}")
        same4 = ""
        if name.startswith(("greedy27", "kff")):
            if not _same_records(_mode_records(outs["cuda"], knobs), ref4):
                raise SystemExit(f"phase 18: mid {name}: the (k-mer, count) "
                                 "set differs from phase 4's")
            same4 = ", (k-mer, count) set == phase 4's"
        launches_all[name] = launches
        written = ", ".join(files) or "no files"
        log(f"[phase 18] mid {name}: card == CPU ({written}; stats "
            f"equal){same4}; n_total {st.get('n_total')} "
            f"n_unique {st.get('n_unique')} n_spills {st.get('n_spills')}; "
            f"launches {launches}; card {wall:.2f} s, cpu {c_wall:.2f} s")
        for prefix in outs.values():
            for p in prefix.parent.glob(prefix.name + ".*"):
                p.unlink()
    return launches_all


def phase_sharded_modes_full(full, devices):
    """Phase 18 at full size: phase 5's FASTQ and knobs over 4 shards, each
    mode timed, with its launches and each card's peak memory."""
    from kmc_tpu_torch import count

    fq, n_reads, ref = full
    base = dict(batch_positions=1 << 22, capacity_rows_per_device=None)
    ref5 = _db_records(WORK / "bench_out")
    # the single-device small-k DB that the sharded one must equal
    t0 = time.perf_counter()
    count([str(fq)], str(WORK / "full18_smallk13_one"), k=13,
          device="cuda")
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    rows = {}
    for name, knobs in SHARDED_MODES_FULL:
        out = WORK / f"full18_{name}"
        for i in range(torch.cuda.device_count()):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(i)
        reset_counts()
        st, wall = run_sharded(fq, out, devices, **dict(base, **knobs))
        launches = _mode_launches()
        peaks = {i: torch.cuda.max_memory_allocated(i)
                 for i in range(torch.cuda.device_count())}
        _check_mode_launches(f"full {name}", knobs, launches)
        k = knobs.get("k", 27)
        if name == "estimate":
            if st["n_reads"] != n_reads or sum(
                    st["estimated_histogram"]) <= 0:
                raise SystemExit(f"phase 18: full -e: n_reads "
                                 f"{st['n_reads']}, histogram sum "
                                 f"{sum(st['estimated_histogram'])}")
            check = (f"n_reads {st['n_reads']}, estimated_histogram[1:4] "
                     f"{st['estimated_histogram'][1:4]}")
        elif st["n_total"] != n_reads * (150 - k + 1):
            raise SystemExit(f"phase 18: full {name}: n_total "
                             f"{st['n_total']} != {n_reads} x {151 - k}")
        elif name == "smallk13":
            one = WORK / "full18_smallk13_one"
            if not _same_db(out, one):
                raise SystemExit("phase 18: the sharded small-k DB differs "
                                 "from the single-device one")
            check = (f"n_total {st['n_total']} (= {n_reads} x 138), DB == "
                     f"the single-device small-k DB ({one_wall:.3f} s)")
        else:
            if not _same_records(_mode_records(out, knobs), ref5):
                raise SystemExit(f"phase 18: full {name}: the (k-mer, count) "
                                 "set differs from phase 5's")
            check = (f"n_total {st['n_total']} (= {n_reads} x 124), "
                     f"n_unique {st['n_unique']}, (k-mer, count) set == "
                     "phase 5's")
        t = st.get("timings", {})
        split = ", ".join(f"{key} {t[key]:.3f}" for key in (
            "stage0_s", "map_build_s", "ingest_wall_s", "owner_hist_s",
            "exchange_groupsort_s", "finalize_exec_s", "finalize_d2h_s",
            "finalize_wall_s") if key in t)
        rows[name] = dict(wall=wall, launches=launches, peaks=peaks,
                          timings=t)
        log(f"[phase 18] full {name} on {devices}: {check}; wall_s "
            f"{wall:.3f}" + (f", {split}" if split else "")
            + f"; launches {launches}; max_memory_allocated {peaks}")
        for p in out.parent.glob(out.name + ".*"):
            p.unlink()
    for p in WORK.glob("full18_smallk13_one.*"):
        p.unlink()
    return rows


@contextlib.contextmanager
def plain_step_kernels():
    """The SPMD step's kernels replaced by their plain versions: the
    scan entry, the grouping sort and the dense exchange (the names the
    step's modules call them by)."""
    import kmc_tpu_torch.ops.sortcount as sortcount
    import kmc_tpu_torch.ops.store as store
    import kmc_tpu_torch.parallel.distributed as dist
    from kmc_tpu_torch.ops.extract_kernel import splitter_scan_plain
    from kmc_tpu_torch.ops.sort_kernel import radix_sort_plain
    from kmc_tpu_torch.parallel.exchange_kernel import all_to_all_plain

    patches = ((sortcount, "extract_splitter_scan", splitter_scan_plain),
               (store, "radix_sort_columns", radix_sort_plain),
               (dist, "radix_sort_columns", radix_sort_plain),
               (dist, "all_to_all", all_to_all_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_distributed_step(full, devices, s=1 << 22, k=27):
    """Phase 18's SPMD count step: phase 5's batches of 2^22 positions in
    rounds of 4 (the last padded with empty batches) through
    make_distributed_count_step over 4 shards with the prefix map.  Each
    round's outputs == the same step with the plain versions of its
    kernels; the summed counts == phase 5's n_total; device time per
    round from torch.profiler; the launches of the dense exchange, the
    sort and the scan entry in the kernel run."""
    import itertools

    from kmc_tpu_torch.io.readers import (BatchStream, ParseState,
                                          batch_len, file_code_stream)
    from kmc_tpu_torch.ops.store import prefix_bin_bits, prefix_sig_map
    from kmc_tpu_torch.parallel.distributed import (
        make_distributed_count_step)

    fq, n_reads, _ = full
    D = len(devices)
    t0 = time.perf_counter()
    batches = list(BatchStream(s, k).batches(
        file_code_stream([str(fq)], "fastq", ParseState())))
    while len(batches) % D:
        batches.append(np.full(batch_len(s, k), 4, np.uint8))
    rounds = [[torch.from_numpy(b).to(dev) for b, dev in
               zip(batches[i:i + D], devices)]
              for i in range(0, len(batches), D)]
    del batches
    sig_map = prefix_sig_map(M, prefix_bin_bits(k, M, 512)[0])
    parse_s = time.perf_counter() - t0
    step, cap = make_distributed_count_step(devices, s=s, k=k, sig_len=M)
    W = (k + 15) // 16
    _sync_all()
    reset_counts()
    t0 = time.perf_counter()
    outs = []
    for codes in rounds:
        words, counts, n_out, n_dropped = step(codes, sig_map)
        outs.append((words, counts, n_out, n_dropped))
    _sync_all()
    wall = time.perf_counter() - t0
    w = _wrappers()
    launches = {name: w[name].launches for name in
                ("all_to_all", "radix_sort", "splitter_scan")}
    if min(launches.values()) == 0 or launches["all_to_all"] != \
            len(set(devices)) * len(rounds):
        raise SystemExit(f"phase 18: the SPMD step launched {launches} in "
                         f"{len(rounds)} rounds of {D} shards (the exchange "
                         "must launch once a card)")
    total, err, n_dropped_all = 0, 0, 0
    for codes, (words, counts, n_out, n_dropped) in zip(rounds, outs):
        with plain_step_kernels():
            want = step(codes, sig_map)
        for got_t, want_t in zip((words, counts, n_out, n_dropped), want):
            for a, b in zip(got_t, want_t):
                if a.dim():
                    err = max(err, max_abs_err(a, b))
                if not torch.equal(a, b):
                    raise SystemExit("phase 18: the SPMD step's kernel "
                                     "outputs differ from its plain "
                                     f"version's (max_abs_err {err})")
        for c, n in zip(counts, n_out):
            total += int((c[:int(n)].to(torch.int64) & 0xFFFFFFFF).sum())
        n_dropped_all += sum(int(x) for x in n_dropped)
    del outs
    want_total = n_reads * (150 - k + 1)
    if n_dropped_all or total != want_total:
        raise SystemExit(f"phase 18: the SPMD step counted {total} k-mers "
                         f"({n_dropped_all} rows dropped), phase 5 "
                         f"{want_total}")
    it = itertools.cycle(rounds)
    dev_ms, items, by_name = _profiled_device(
        lambda: step(next(it), sig_map), len(rounds))
    with plain_step_kernels():
        t1 = time.perf_counter()
        for codes in rounds:
            step(codes, sig_map)
        _sync_all()
        plain_wall = time.perf_counter() - t1
    xrow = _step_exchange_times(rounds[0], sig_map, devices, s, k, cap)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:6]
    log(f"[phase 18] SPMD step s=2^{s.bit_length() - 1} k={k} on "
        f"{devices}, capacity {cap}: "
        f"{len(rounds)} rounds of {D} batches (parse {parse_s:.1f} s); "
        f"every round == the plain kernels' step bit for bit (max_abs_err "
        f"{err}); summed counts {total} == phase 5's n_total, 0 rows "
        f"dropped; wall {wall:.3f} s ({wall / len(rounds) * 1e3:.2f} ms a "
        f"round), plain {plain_wall:.3f} s; device_ms a round {dev_ms} over "
        f"{items} device items (torch.profiler; top: " + ", ".join(
            f"{n} {t:.3f}" for n, t in top) + f"); launches {launches}; "
        f"W {W}")
    del rounds
    for d in set(devices):
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    return dict(launches=launches, device_ms=dev_ms, wall=wall,
                plain_wall=plain_wall, max_abs_err=err, exchange=xrow)


def _step_exchange_times(codes, sig_map, devices, s, k, cap):
    """The dense exchange at the SPMD step's shapes: one round's send
    buffers (D x [D, cap, W + 1] int32), the kernel against its plain
    version bit for bit, then each timed, with the library call (a stack
    and a transpose) and the bound: the bytes it must move (each segment
    read once and written once) over the device memory rate, or on
    distinct cards the busiest owner's peer bytes over NVLink.  CUDA
    events on one card; the host clock around whole exchanges across
    cards (events do not span cards)."""
    from kmc_tpu_torch.parallel.distributed import _local_count_step
    from kmc_tpu_torch.parallel.exchange_kernel import (all_to_all,
                                                        all_to_all_plain)

    D = len(devices)
    sm = torch.from_numpy(sig_map.astype(np.int64))
    sends = [_local_count_step(c, sm.to(c.device), s=s, k=k, sig_len=M,
                               both_strands=True, capacity=cap, D=D)[0]
             for c in codes]
    got, want = all_to_all(sends), all_to_all_plain(sends)
    _sync_all()
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"phase 18: the dense exchange at the step's "
                         f"shapes differs from plain (max_abs_err {err})")
    del got, want
    C = sends[0].shape[2]
    one_card = len(set(devices)) == 1
    if one_card:
        ms = cuda_ms(lambda: all_to_all(sends), 10)
        plain_ms = cuda_ms(lambda: all_to_all_plain(sends), 3)
        library_ms = cuda_ms(
            lambda: torch.stack(sends).transpose(0, 1).contiguous(), 3)
        nbytes = 2 * 4 * C * D * D * cap
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    else:
        ms = host_ms(lambda: all_to_all(sends), 10)
        plain_ms = host_ms(lambda: all_to_all_plain(sends), 3)
        library_ms = host_ms(lambda: [
            torch.stack([x[r].to(devices[r]) for x in sends])
            for r in range(D)], 3)
        nbytes = (D - 1) * cap * C * 4  # the busiest owner's peer reads
        bound_ms = nbytes / NVLINK_BYTES_PER_S * 1e3
    log(f"[phase 18] dense exchange at the step's shapes, {D} x [{D}, "
        f"{cap}, {C}] int32 on {devices}: bit-exact; kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms (stack + transpose) "
        f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({nbytes} bytes "
        + ("over the device memory)" if one_card else "over NVLink)")
        + ("" if one_card else "; host clock"))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, max_abs_err=err)


def phase_sharded_modes(fq_mid, full):
    """Phase 18: the sharded count's other modes (small k, the greedy map,
    KFF, -e, --opt-out-size) at mid and full size, then the SPMD count
    step."""
    devices = shard_devices()
    mid = phase_sharded_modes_mid(fq_mid, devices)
    full_rows = phase_sharded_modes_full(full, devices)
    step = phase_distributed_step(full, devices)
    return dict(mid=mid, full=full_rows, step=step)


# -- phase 19: multi-process counting (torch.distributed) --

MP_WORKER = ROOT / "tests" / "torch_multiproc_worker.py"
# phase 19's mid-size modes: (worker mode, the single-process count's knobs)
MP_MID_BUDGET = 60_000_000  # spill bytes: re-merges shards of 2^19 rows
MP_MODES_MID = (("default", {}), ("k13", dict(k=13)),
                ("kff", dict(output_type="kff")),
                ("e", dict(estimate_only=True)),
                ("greedy", dict(signature_map_policy="greedy")),
                (f"spill@{MP_MID_BUDGET}",
                 dict(capacity_rows_per_device=1 << 19)))
# the process group's per-rank results that are not global
MP_LOCAL = ("n_reads_local", "consumed_bytes_local", "timings",
            "n_processes")


def mp_layout():
    """(processes, each process's MP_DEVICES): four processes, one card
    each, on a machine of four or more cards; else two processes of two
    shards each on card 0.  Four shards either way."""
    if torch.cuda.device_count() >= 4:
        return 4, "cuda:{pid}"
    return 2, "cuda:0,cuda:0"


def run_workers(reads, out: Path, env: dict, n_procs: int, timeout=900,
                phase=19):
    """tests/torch_multiproc_worker.py as n_procs processes (gloo, through
    a file:// store), each its own fresh interpreter; fails the phase when
    one exits non-zero.  Returns the seconds to the last one's exit."""
    init = WORK / f"{out.name}_pg"
    init.unlink(missing_ok=True)
    env = dict(os.environ, **{k: str(v) for k, v in env.items()})
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(MP_WORKER), f"file://{init}", str(n_procs),
         str(pid), str(reads), str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(n_procs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise SystemExit(f"phase {phase}: worker {pid} exited "
                             f"{p.returncode}:\n{text[-3000:]}")
    init.unlink(missing_ok=True)
    return wall


def worker_results(out: Path, mode: str, n_procs: int) -> list:
    name = mode.replace("@", "_")
    return [json.loads(Path(f"{out}.{name}.stats.{pid}").read_text())
            for pid in range(n_procs)]


def _mp_uses(knobs):
    """The kernels a mode's workers must launch (fused ingest, sort and the
    cross-process exchange on the store's routes; the greedy entry and the
    scan entry for greedy) and the in-process exchange, which they must
    not."""
    if knobs.get("estimate_only") or knobs.get("k", 27) < 14:
        return ()
    uses = ("fused_ingest", "radix_sort", "ragged_all_to_all_processes")
    if knobs.get("signature_map_policy") == "greedy":
        uses += ("greedy_entry", "splitter_scan")
    return uses


def mp_leads(n_procs):
    """The cross-process exchange's launches a count makes on each rank:
    one a card, by the lowest rank on it (mp_layout: every rank of four on
    four cards, rank 0 of two on card 0)."""
    return [1] * n_procs if n_procs == 4 else [1] + [0] * (n_procs - 1)


def _check_mp_launches(label, knobs, res, phase=19):
    """Each rank launched the kernels its mode uses and no other, and the
    cross-process exchange once for each card it leads whose senders sent
    a row (a shard may have spilled every row before finalize)."""
    uses = _mp_uses(knobs)
    sent = [r["exchange_sent_rows"] for r in res]
    if len(res) != 4:  # every shard on card 0
        sent = [sum(sent)] + [0] * (len(res) - 1)
    leads = [lead * (n > 0) for lead, n in zip(mp_leads(len(res)), sent)]
    for pid, (r, lead) in enumerate(zip(res, leads)):
        got = r["kernels"]
        xp = "ragged_all_to_all_processes"
        if any((got[k] > 0) != (k in uses) for k in got if k != xp) or (
                got[xp] != (lead if xp in uses else 0)):
            raise SystemExit(f"phase {phase}: {label} rank {pid} launched "
                             f"{got}, "
                             f"it must launch {uses} ({lead} cross-process "
                             "exchange launches: one a card with rows to "
                             "send, by its lowest rank) and no other")


def _same_stats(label, res, single, phase=19):
    """Every rank's stats == the single-process count's, but the local
    ones; the ranks agree."""
    want = {k: v for k, v in json.loads(json.dumps(single)).items()
            if k not in MP_LOCAL}
    for pid, r in enumerate(res):
        got = {k: v for k, v in r["stats"].items() if k not in MP_LOCAL}
        if got != want:
            raise SystemExit(f"phase {phase}: {label} rank {pid} stats {got} "
                             "!= "
                             f"the single-process count's {want}")


def _group_modes(fq, out: Path, n_procs: int, env: dict, devices, knobs,
                 modes, phase: int, on_cards: bool = True):
    """Every mode of `modes` ((worker mode, the single-process count's
    knobs)) by n_procs workers (env: their MP_* knobs; every process reads
    the whole stream, so the deal, the compactions and the spills are the
    single process's) against the single-process count over `devices`
    with `knobs`: files byte for byte and global stats; on cards each
    rank's launches.  Returns {mode: (each rank's result, the single
    count's stats, its wall)}."""
    import dataclasses

    from kmc_tpu_torch import memory

    wall = run_workers(fq, out, dict(env, MP_MODES=",".join(
        m for m, _ in modes)), n_procs, phase=phase)
    log(f"[phase {phase}] {out.name}: {n_procs} processes "
        f"({env['MP_DEVICES']}) ran {len(modes)} modes in {wall:.1f} s")
    planned = memory.plan_memory
    rows = {}
    for mode, mode_knobs in modes:
        res = worker_results(out, mode, n_procs)
        name, _, budget = mode.partition("@")
        single = WORK / f"{out.name}_single_{name}"
        if budget:
            memory.plan_memory = lambda *a, **kw: dataclasses.replace(
                planned(*a, **kw), spill_budget_bytes=int(budget))
        try:
            st, s_wall = run_sharded(fq, single, devices,
                                     **dict(knobs, **mode_knobs))
        finally:
            memory.plan_memory = planned
        _same_stats(f"{out.name} {mode}", res, st, phase)
        files = _route_files(single)
        mine = [suf for suf in _route_files(Path(
            f"{out}.{mode.replace('@', '_')}")) if not suf.startswith(
                ".stats")]
        if files != mine or bool(files) == (name == "e"):
            raise SystemExit(f"phase {phase}: {out.name} {mode} wrote {mine}, "
                             f"the single-process count {files}")
        for suf in files:
            a = Path(f"{out}.{mode.replace('@', '_')}{suf}").read_bytes()
            if a != Path(f"{single}{suf}").read_bytes():
                raise SystemExit(f"phase {phase}: {out.name} {mode}: {suf} "
                                 "differs from the single-process count's")
        if on_cards:
            _check_mp_launches(f"{out.name} {mode}", mode_knobs, res, phase)
        elif any(n for r in res for n in r["kernels"].values()):
            raise SystemExit(f"phase {phase}: {out.name} {mode}: CPU shards "
                             f"launched {[r['kernels'] for r in res]}")
        if name == "spill" and (st["n_spills"] < 2 or st["n_remerges"] < 1):
            raise SystemExit(f"phase {phase}: {out.name} spill: "
                             f"{st['n_spills']} spills, {st['n_remerges']} "
                             "re-merges")
        rows[mode] = (res, st, s_wall)
        log(f"[phase {phase}] {out.name} {mode}: {n_procs} processes == one "
            f"process over {len(devices)} {devices[0].split(':')[0]} shards "
            f"({', '.join(files) or 'no files'}; stats equal); n_total "
            f"{st.get('n_total')} n_spills {st.get('n_spills')} n_remerges "
            f"{st.get('n_remerges')}; exchange launches by rank "
            f"{[r['launches'] for r in res]}; walls by rank "
            f"{[round(r['wall_s'], 3) for r in res]} s, one process "
            f"{s_wall:.3f} s")
        for prefix in (single, Path(f"{out}.{mode.replace('@', '_')}")):
            for q in prefix.parent.glob(prefix.name + ".*"):
                q.unlink()
    return rows


def phase_mp_mid(fq_mid):
    """Phase 19 at mid size: every mode of the process group against the
    single-process count over 4 shards on the card."""
    n_procs, devs = mp_layout()
    rows = _group_modes(fq_mid, WORK / "mp_mid", n_procs, dict(
        MP_DEVICES=devs, MP_K=27, MP_CI=2, MP_BATCH=1 << 18,
        MP_CAPACITY=3 << 19, MP_SHARD_INPUT=0, MP_SPILL_CAPACITY=1 << 19),
        shard_devices(), dict(batch_positions=1 << 18,
                              capacity_rows_per_device=3 << 19),
        MP_MODES_MID, 19)
    return {mode: dict(walls=[r["wall_s"] for r in res],
                       launches=[r["launches"] for r in res])
            for mode, (res, _, _) in rows.items()}


def _group_full(full, out: Path, n_procs: int, env: dict, phase: int):
    """Phase 5's FASTQ and knobs by n_procs workers (env: their MP_*
    knobs) parsing disjoint byte ranges of it, shards of 2^26 rows: the
    ranks' stats agree, the DB == phase 5's, n_total and n_super_kmers ==
    phase 5's, every byte parsed once, each rank's launches.  Returns
    (each rank's result, the seconds to the last exit)."""
    fq, n_reads, ref = full
    wall = run_workers(fq, out, dict(
        env, MP_K=27, MP_CI=2, MP_BATCH=1 << 22, MP_CAPACITY=1 << 26,
        MP_MODES="default"), n_procs, phase=phase)
    res = worker_results(out, "default", n_procs)
    st = res[0]["stats"]
    if any({k: v for k, v in r["stats"].items() if k not in MP_LOCAL}
           != {k: v for k, v in st.items() if k not in MP_LOCAL}
           for r in res):
        raise SystemExit(f"phase {phase}: full size: the ranks' stats "
                         "differ")
    if st["n_total"] != n_reads * 124 or st["n_reads"] != n_reads:
        raise SystemExit(f"phase {phase}: full size n_total {st['n_total']}, "
                         f"n_reads {st['n_reads']}")
    if st["n_super_kmers"] != ref.n_super_kmers:
        raise SystemExit(f"phase {phase}: full size n_super_kmers "
                         f"{st['n_super_kmers']} != phase 5's "
                         f"{ref.n_super_kmers}")
    if not _same_db(Path(f"{out}.default"), WORK / "bench_out"):
        raise SystemExit(f"phase {phase}: full-size DB differs from phase "
                         "5's")
    parsed = [r["stats"]["consumed_bytes_local"] for r in res]
    if sum(parsed) != fq.stat().st_size or min(parsed) <= 0:
        raise SystemExit(f"phase {phase}: the processes parsed {parsed} "
                         f"bytes of {fq.stat().st_size}")
    _check_mp_launches("full", {}, res, phase)
    return res, wall


def phase_mp_full(full):
    """Phase 19 at full size: phase 5's FASTQ and knobs, the processes
    parsing disjoint byte ranges of it, 4 shards of 2^26 rows: the DB ==
    phase 5's, n_total and n_super_kmers == phase 5's; walls, stage
    seconds, peak device memory and the cross-process exchange's kernel
    time against its bytes' bound, per rank."""
    fq, n_reads, ref = full
    n_procs, devs = mp_layout()
    out = WORK / "mp_full"
    res, wall = _group_full(full, out, n_procs, dict(MP_DEVICES=devs), 19)
    st = res[0]["stats"]
    # the exchange on the card: from the first launching process's launch
    # to the last one's synchronize (one monotonic clock on the machine);
    # what the slowest card's kernel (CUDA events) leaves of that span is
    # the launch skew between the processes
    spans = [r["exchange_span"] for r in res if r["exchange_span"]]
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) * 1e3
    ms = max(r["exchange_ms"] for r in res)
    nbytes = sum(r["exchange_bytes"] for r in res)
    # one card moves every byte; on four cards each its owners', the rows
    # of other cards' senders over its NVLink (450 GB/s in)
    if n_procs == 2:
        bound = nbytes / HBM_BYTES_PER_S * 1e3
    else:
        bound = max(max(r["exchange_bytes"] for r in res) / HBM_BYTES_PER_S,
                    max(r["exchange_peer_bytes"] for r in res)
                    / NVLINK_BYTES_PER_S) * 1e3
    keys = ("ingest_wall_s", "owner_hist_s", "exchange_groupsort_s",
            "finalize_exec_s", "finalize_d2h_s", "finalize_wall_s")
    for pid, r in enumerate(res):
        t = r["stats"]["timings"]
        log(f"[phase 19] full size rank {pid} ({devs.replace('{pid}', str(pid))}): "
            f"wall_s {r['wall_s']:.3f}, " + ", ".join(
                f"{k} {t[k]:.3f}" for k in keys)
            + f", route {t['exchange_route']}, parsed "
            f"{r['stats']['consumed_bytes_local']} bytes "
            f"({r['stats']['n_reads_local']} reads), peak device memory "
            f"{r['peak_bytes']}, launches {r['kernels']}, cross-process "
            f"exchange {r['exchange_ms']:.4f} ms for {r['exchange_bytes']} "
            "bytes")
    log(f"[phase 19] full size, {n_procs} processes x {4 // n_procs} shards "
        f"of 2^26 rows: DB == phase 5 DB byte for byte; n_total "
        f"{st['n_total']} (= {n_reads} x 124), n_super_kmers "
        f"{st['n_super_kmers']} == phase 5's; all processes {wall:.3f} s; "
        f"the cross-process exchange {span_ms:.4f} ms from the first "
        f"launch to the last synchronize (host clock; the slowest card's "
        f"kernel {ms:.4f} ms by CUDA events, launch skew "
        f"{span_ms - ms:.4f} ms) for {nbytes} bytes, bound_ms {bound:.4f}; "
        f"launches by rank {[r['launches'] for r in res]}")
    for q in WORK.glob("mp_full.*"):
        q.unlink()
    return dict(ms=span_ms, event_ms=ms, skew_ms=span_ms - ms, bound_ms=bound,
                bytes=nbytes, launches=[r["launches"] for r in res],
                walls=[r["wall_s"] for r in res])


_IPC_BENCH = r"""
import json, sys
sys.path.insert(0, sys.argv[5])
import numpy as np, torch
import torch.distributed as dist
from kmc_tpu_torch.parallel import exchange_kernel as xk
from kmc_tpu_torch.parallel.distributed import init_multihost, nccl_group

init, n_procs, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
xp = xk.ragged_all_to_all_processes
host = None
if len(sys.argv) > 6:  # emulated nodes: argv[6] lists each rank's
    import socket
    host = "node" + sys.argv[6].split(",")[rank]
    socket.gethostname = lambda: host
init_multihost(init, n_procs, rank)
dev = torch.device("cuda", rank if n_procs == 4 else 0)
D, cap, C, reps = 4, 1 << 24, 2, 10
per = D // n_procs
layout = [list(range(p * per, (p + 1) * per)) for p in range(n_procs)]
mine = layout[rank]
# phase 7's senders and counts, made alike in every process
gen = torch.Generator(device=dev).manual_seed(C)
full = [torch.randint(-2**31, 2**31 - 1, (D, cap, C), generator=gen,
                      dtype=torch.int32, device=dev) for _ in range(D)]
n_rows = np.random.default_rng(C).integers(0, cap + 1, size=(D, D))
n_rows[0, 1], n_rows[1, 2], n_rows[2, 3] = 0, cap, 12345
ok, ms, nccl_ms, spans = True, [], [], []
for rep in range(reps + 1):
    xs = []
    for j in mine:
        buf = xk.send_buffer((D, cap, C), dev, True)
        buf.copy_(full[j])
        xs.append(buf)
    before = xp.kernel_ms, xp.nccl_ms
    outs, recv = xp(xs, n_rows, layout)
    if rep == 0:
        for l, o in enumerate(mine):
            for j in range(D):
                m = int(n_rows[j, o])
                ok &= bool(torch.equal(outs[l][j, :m], full[j][o, :m]))
    else:
        ms.append(xp.kernel_ms - before[0])
        nccl_ms.append(xp.nccl_ms - before[1])
        spans.append(xp.span)  # None on a rank that leads no card
    del xs, outs
json.dump({"ok": ok, "ms": ms, "nccl_ms": nccl_ms, "spans": spans,
           "launches": xp.launches, "bytes": xp.bytes // (reps + 1),
           "cross_bytes": xp.cross_node_bytes // (reps + 1),
           "opens": xp.cross_node_opens, "node": host,
           "nccl_init_s": nccl_group.init_s,
           "nccl_warmup_s": nccl_group.warmup_s}, open(out, "w"))
dist.destroy_process_group()
"""

# The yardstick of the exchange across processes: NCCL's
# all_to_all_single of the same rows (phase 7's senders and counts, one
# process a card), first launch to last synchronize on the host clock, each
# rank's CUDA events beside it.  The port never calls NCCL.
_NCCL_BENCH = r"""
import json, sys, time
import numpy as np, torch
import torch.distributed as dist

init, n_procs, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
dev = torch.device("cuda", rank if n_procs == 4 else 0)
torch.cuda.set_device(dev)
D, cap, C, reps = 4, 1 << 24, 2, 10
per = D // n_procs
procs = [list(range(p * per, (p + 1) * per)) for p in range(n_procs)]
mine = procs[rank]
gen = torch.Generator(device=dev).manual_seed(C)
full = [torch.randint(-2**31, 2**31 - 1, (D, cap, C), generator=gen,
                      dtype=torch.int32, device=dev) for _ in range(D)]
n_rows = np.random.default_rng(C).integers(0, cap + 1, size=(D, D))
n_rows[0, 1], n_rows[1, 2], n_rows[2, 3] = 0, cap, 12345
# to process q: owner by owner of q's, each local sender's rows
send = torch.cat([full[j][o, :n_rows[j, o]].reshape(-1)
                  for q in procs for o in q for j in mine])
in_split = [int(sum(n_rows[j, o] for o in q for j in mine)) * C
            for q in procs]
out_split = [int(sum(n_rows[j, o] for o in mine for j in q)) * C
             for q in procs]
want = torch.cat([full[j][o, :n_rows[j, o]].reshape(-1)
                  for q in procs for o in mine for j in q])
del full
recv = torch.empty(sum(out_split), dtype=torch.int32, device=dev)
try:
    dist.init_process_group("nccl", init_method=init, world_size=n_procs,
                            rank=rank, device_id=dev)
    ms, spans = [], []
    for rep in range(reps + 1):
        dist.barrier()
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        a.record()
        dist.all_to_all_single(recv, send, out_split, in_split)
        b.record()
        torch.cuda.synchronize(dev)
        t1 = time.monotonic()
        if rep == 0:
            ok = bool(torch.equal(recv, want))
        else:
            ms.append(a.elapsed_time(b))
            spans.append((t0, t1))
    result = {"ok": ok, "ms": ms, "spans": spans,
              "bytes": 2 * 4 * (recv.numel())}
    dist.destroy_process_group()
except Exception as e:  # the yardstick's own failure, reported as such
    result = {"ok": False, "refused": f"{type(e).__name__}: {e}"[:1500]}
json.dump(result, open(out, "w"))
"""


def _run_bench(script, name, n_procs, *args, timeout=600):
    """script as n_procs processes (argv: init URL, n_procs, rank, result
    file, *args); returns each process's JSON result, None for a process
    that wrote none, and each process's exit code and output."""
    init = WORK / f"{name}_pg"
    init.unlink(missing_ok=True)
    outs = [WORK / f"{name}.{pid}" for pid in range(n_procs)]
    for o in outs:
        o.unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, f"file://{init}", str(n_procs),
         str(pid), str(outs[pid]), *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(n_procs)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0].decode(
                    errors="replace"))
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0].decode(errors="replace")
                            + f"\n(killed after {timeout} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [json.loads(o.read_text()) if o.exists() else None for o in outs]
    for o in outs + [init]:
        o.unlink(missing_ok=True)
    return res, [p.returncode for p in procs], logs


def _span_stats(res):
    """Per exchange: the span from the first launching process's launch to
    the last one's synchronize, the slowest card's events, and the skew
    (span minus those events); means over the exchanges."""
    spans, skews = [], []
    for i in range(len(res[0]["spans"])):
        sp = [r["spans"][i] for r in res if r["spans"][i]]
        span = (max(b for _, b in sp) - min(a for a, _ in sp)) * 1e3
        spans.append(span)
        skews.append(span - max(r["ms"][i] for r in res))
    return float(np.mean(spans)), min(spans), float(np.mean(skews))


def phase_mp_exchange(exchange):
    """The cross-process exchange alone at phase 7's shapes (4 senders of
    [4, 2^24, 2], phase 7's counts), each process's senders in IPC memory:
    bit-exact against the senders' rows with one launch a card, timed from
    the first launching process's launch to the last one's synchronize on
    the host clock (mean of 10 exchanges after one; each card's CUDA
    events and the launch skew beside it), beside phase 7's in-process
    kernel; then NCCL's all_to_all_single of the same rows as the
    yardstick (on one card, two NCCL ranks on one GPU: whether NCCL takes
    them)."""
    n_procs, _ = mp_layout()
    res, rcs, logs = _run_bench(_IPC_BENCH, "mp_bench", n_procs, str(ROOT))
    for pid, (rc, text) in enumerate(zip(rcs, logs)):
        if rc:
            raise SystemExit(f"phase 19: exchange bench process {pid} exited "
                             f"{rc}:\n{text[-3000:]}")
    if not all(r["ok"] for r in res):
        raise SystemExit("phase 19: the cross-process exchange delivered "
                         "rows that differ from the senders'")
    leads = [lead * 11 for lead in mp_leads(n_procs)]
    if [r["launches"] for r in res] != leads:
        raise SystemExit(f"phase 19: exchange bench launches "
                         f"{[r['launches'] for r in res]}, one a card by its "
                         f"lowest rank would be {leads}")
    ms, best, skew = _span_stats(res)
    nbytes = sum(r["bytes"] for r in res)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    if n_procs == 4:  # rows that cross cards go over NVLink
        rng = np.random.default_rng(2)
        n_rows = rng.integers(0, (1 << 24) + 1, size=(4, 4))
        n_rows[0, 1], n_rows[1, 2], n_rows[2, 3] = 0, 1 << 24, 12345
        peer = n_rows * (1 - np.eye(4, dtype=np.int64))
        link = max(peer.sum(0).max(), peer.sum(1).max()) * 4 * 2
        bound = max(bound / 4, link / NVLINK_BYTES_PER_S * 1e3)
    event_ms = [float(np.mean(r["ms"])) for r in res]
    x2 = exchange[2]
    log(f"[phase 19] cross-process exchange, {n_procs} processes, 4 x "
        f"[4, 2^24, 2]: bit-exact, one launch a card; {ms:.4f} ms (mean of "
        f"10; best {best:.4f}) from the first launch to the last "
        f"synchronize (host clock), each process's kernel by CUDA events "
        f"{[round(e, 4) for e in event_ms]} ms (0: it led no card), launch "
        f"skew {skew:.4f} ms, for {nbytes} bytes, bound_ms {bound:.4f}; in "
        f"one process (phase 7) kernel_ms {x2['ms']:.4f} (CUDA events) "
        f"bound_ms {x2['bound_ms']:.4f}")
    out = dict(ms=ms, best=best, skew_ms=skew, event_ms=event_ms,
               bound_ms=bound, bytes=nbytes)
    res, rcs, logs = _run_bench(_NCCL_BENCH, "nccl_bench", n_procs,
                                timeout=240)
    if all(r and r["ok"] for r in res):
        ms, best_ms, skew = _span_stats(res)
        out.update(nccl_ms=ms, nccl_event_ms=[float(np.mean(r["ms"]))
                                              for r in res], nccl_note=None)
        log(f"[phase 19] NCCL all_to_all_single, {n_procs} processes, the "
            f"same rows ({sum(r['bytes'] for r in res)} bytes read and "
            f"written):"
            f" bit-exact; {ms:.4f} ms (mean of 10; best {best_ms:.4f}) from "
            f"the first launch to the last synchronize (host clock), each "
            f"rank's CUDA events {out['nccl_event_ms']} ms, skew "
            f"{skew:.4f} ms")
    else:
        why = [r.get("refused") if r else f"exit {rc}: {text[-400:]}"
               for r, rc, text in zip(res, rcs, logs)]
        if n_procs == 4:
            raise SystemExit(f"phase 19: NCCL all_to_all_single on four "
                             f"cards failed: {why}")
        out.update(nccl_ms=None, nccl_event_ms=None,
                   nccl_note=f"NCCL refused {n_procs} ranks on one GPU: "
                   f"{why[0]}"[:600])
        log(f"[phase 19] {out['nccl_note']}")
    return out


def phase_multiprocess(fq_mid, full, exchange):
    """Phase 19: multi-process counting, at mid size against one process,
    at full size against phase 5, then the cross-process exchange alone."""
    mid = phase_mp_mid(fq_mid)
    full_row = phase_mp_full(full)
    bench = phase_mp_exchange(exchange)
    return dict(mid=mid, full=full_row, bench=bench)


# -- phase 20: counting across nodes (two emulated nodes) --

MN_NODES = "0,0,1,1"  # MP_NODE: ranks 0-1 on one emulated node, 2-3 on another
# the CPU emulation of a machine with fewer than four cards: phase 4's
# first reads, shards that spill at 2^16 rows and re-merge under 30 MB
MN_CPU_READS = 16000
MN_CPU_BUDGET = 30_000_000
MN_CPU_MODES = MP_MODES_MID[:-1] + (
    (f"spill@{MN_CPU_BUDGET}", dict(capacity_rows_per_device=1 << 16)),)


def _check_node_results(label, res, knobs, route):
    """Each rank recorded its emulated node, opened no handle of the other
    node, and (store modes) took `route`, the card routes moving rows
    across nodes on the NCCL leg."""
    nodes = [r["node"] for r in res]
    if nodes != [f"node{n}" for n in MN_NODES.split(",")]:
        raise SystemExit(f"phase 20: {label}: the ranks' nodes {nodes}")
    opens = [r["exchange_cross_node_opens"] for r in res]
    if any(opens):
        raise SystemExit(f"phase 20: {label}: IPC opens of another node's "
                         f"handles {opens}")
    if knobs.get("estimate_only") or knobs.get("k", 27) < 14:
        return
    got = {r["stats"]["timings"]["exchange_route"] for r in res}
    if got != {route}:
        raise SystemExit(f"phase 20: {label}: exchange routes {got}")
    if route.endswith("+nccl"):
        crossed = [r["exchange_cross_node_bytes"] for r in res]
        legs = [r["exchange_nccl_ms"] for r in res]
        if not sum(crossed) or any(b and not ms
                                   for b, ms in zip(crossed, legs)):
            raise SystemExit(f"phase 20: {label}: cross-node bytes {crossed}, "
                             f"NCCL leg ms {legs}")


def phase_nodes_cpu(fq_mid):
    """Phase 20 on a machine of fewer than four cards: the same two-node
    emulation (four processes, nodes {0, 1} and {2, 3}) on CPU shards over
    phase 4's first MN_CPU_READS reads, every mode of phase 19 against one
    process, and the input split by bytes against it; the NCCL leg needs
    cards of their own, at least two."""
    fq = WORK / "mn_head.fastq"
    _head_fastq(fq_mid, fq, MN_CPU_READS)
    env = dict(MP_DEVICES="cpu", MP_NODE=MN_NODES, MP_K=27, MP_CI=2,
               MP_BATCH=1 << 16, MP_CAPACITY=1 << 19, MP_SHARD_INPUT=0,
               MP_SPILL_CAPACITY=1 << 16)
    knobs = dict(batch_positions=1 << 16, capacity_rows_per_device=1 << 19)
    rows = _group_modes(fq, WORK / "mn_cpu", 4, env, ["cpu"] * 4, knobs,
                        MN_CPU_MODES, 20, on_cards=False)
    for mode, (res, _, _) in rows.items():
        _check_node_results(f"cpu {mode}", res, dict(MN_CPU_MODES)[mode],
                            "plain+p2p")
    out = WORK / "mn_cpu_sharded"
    run_workers(fq, out, dict(env, MP_SHARD_INPUT=1, MP_MIN_SHARD=4096,
                              MP_MODES="default"), 4, phase=20)
    res = worker_results(out, "default", 4)
    _check_node_results("cpu sharded input", res, {}, "plain+p2p")
    single = WORK / "mn_cpu_single"
    st, _ = run_sharded(fq, single, ["cpu"] * 4, **knobs)
    parsed = [r["stats"]["consumed_bytes_local"] for r in res]
    if not _same_db(Path(f"{out}.default"), single) or min(parsed) <= 0 \
            or sum(parsed) != fq.stat().st_size or any(
                r["stats"][k] != st[k] for r in res
                for k in ("n_total", "n_unique", "n_super_kmers")):
        raise SystemExit("phase 20: cpu sharded input: the DB or stats "
                         "differ from one process's, or the byte ranges "
                         f"{parsed} do not cover the input")
    for q in list(WORK.glob("mn_cpu*")) + [fq]:
        q.unlink()
    log(f"[phase 20] two emulated nodes x two processes on CPU shards: "
        f"{len(rows)} modes and the input split by bytes == one process; "
        f"the NCCL leg needs cards of their own, at least two "
        f"({torch.cuda.device_count()} here; phase 20's card run takes "
        f"four): not run")
    return dict(cpu_modes=list(rows), nccl=None)


def phase_nodes_mid(fq_mid):
    """Phase 20 at mid size on four cards: every mode of phase 19 by four
    processes, one card each, in two emulated nodes, against one process
    over the four cards."""
    rows = _group_modes(fq_mid, WORK / "mn_mid", 4, dict(
        MP_DEVICES="cuda:{pid}", MP_NODE=MN_NODES, MP_K=27, MP_CI=2,
        MP_BATCH=1 << 18, MP_CAPACITY=3 << 19, MP_SHARD_INPUT=0,
        MP_SPILL_CAPACITY=1 << 19), shard_devices(),
        dict(batch_positions=1 << 18, capacity_rows_per_device=3 << 19),
        MP_MODES_MID, 20)
    for mode, (res, _, _) in rows.items():
        _check_node_results(f"mid {mode}", res, dict(MP_MODES_MID)[mode],
                            "ipc_kernel+nccl")
        log(f"[phase 20] mid {mode}: NCCL leg ms by rank "
            f"{[round(r['exchange_nccl_ms'], 4) for r in res]} for "
            f"{[r['exchange_cross_node_bytes'] for r in res]} bytes sent "
            f"across nodes; kernel ms {[round(r['exchange_ms'], 4) for r in res]}")
    first = rows[MP_MODES_MID[0][0]][0]
    log(f"[phase 20] mid: the NCCL group, made in the first count "
        f"({MP_MODES_MID[0][0]}): communicator by rank "
        f"{[round(r['nccl_init_s'], 4) for r in first]} s, its cross-node "
        f"pairs' warm-up {[round(r['nccl_warmup_s'], 4) for r in first]} s "
        f"(host clock), of walls {[round(r['wall_s'], 3) for r in first]} s")
    return {mode: dict(walls=[r["wall_s"] for r in res],
                       launches=[r["launches"] for r in res],
                       nccl_ms=[r["exchange_nccl_ms"] for r in res])
            for mode, (res, _, _) in rows.items()}


def _node_spans(res, key="spans"):
    """Per emulated node, the mean over the exchanges of the span from its
    first process's launch or send to its last one's synchronize (spans of
    one node share a clock; those of two nodes do not compose)."""
    out = {}
    for node in dict.fromkeys(r["node"] for r in res):
        mine = [r for r in res if r["node"] == node]
        per = []
        for i in range(len(mine[0][key])):
            sp = [r[key][i] for r in mine if r[key][i]]
            if sp:
                per.append((max(b for _, b in sp) - min(a for a, _ in sp))
                           * 1e3)
        out[node] = float(np.mean(per)) if per else None
    return out


def phase_nodes_full(full):
    """Phase 20 at full size on four cards: phase 5's FASTQ split by bytes
    over four processes in two emulated nodes; DB == phase 5's."""
    res, wall = _group_full(full, WORK / "mn_full", 4, dict(
        MP_DEVICES="cuda:{pid}", MP_NODE=MN_NODES), 20)
    _check_node_results("full", res, {}, "ipc_kernel+nccl")
    spans = _node_spans([dict(r, spans=[r["exchange_span"]]) for r in res])
    log(f"[phase 20] full size, 4 processes in 2 emulated nodes: DB == "
        f"phase 5's byte for byte; all processes {wall:.3f} s; walls by "
        f"rank {[round(r['wall_s'], 3) for r in res]}; kernel ms by rank "
        f"{[round(r['exchange_ms'], 4) for r in res]}; NCCL leg ms by rank "
        f"{[round(r['exchange_nccl_ms'], 4) for r in res]} for "
        f"{[r['exchange_cross_node_bytes'] for r in res]} bytes sent across "
        f"nodes; span by node (host clock) "
        f"{ {n: round(v, 4) for n, v in spans.items() if v} } ms; launches "
        f"by rank {[r['launches'] for r in res]}; cross-node IPC opens "
        f"{sum(r['exchange_cross_node_opens'] for r in res)}")
    for q in WORK.glob("mn_full.*"):
        q.unlink()
    return dict(launches=[r["launches"] for r in res],
                kernel_ms=[r["exchange_ms"] for r in res],
                nccl_ms=[r["exchange_nccl_ms"] for r in res],
                spans=spans, walls=[r["wall_s"] for r in res])


def _node_bounds(n_rows, nodes, row_bytes):
    """Bounds of the two legs, one shard a card: the on-node kernel's
    (each card's own rows over HBM, the rows between cards of a node over
    NVLink's 450 GB/s each way), the NCCL leg's (the busiest card's
    cross-node rows in or out over NVLink: these nodes are emulated on one
    machine, so this is no InfiniBand figure) and both legs' together (they
    share a card's links here); ms."""
    nodes = np.asarray(nodes)
    same = nodes[:, None] == nodes[None, :]
    eye = np.eye(len(nodes), dtype=bool)
    on = n_rows * same
    link = n_rows * (same & ~eye)
    cross = n_rows * ~same
    hbm = (on.sum(1) + on.sum(0)) * row_bytes / HBM_BYTES_PER_S
    k_link = np.maximum(link.sum(1), link.sum(0)) * row_bytes
    x_link = np.maximum(cross.sum(1), cross.sum(0)) * row_bytes
    both = np.maximum((link + cross).sum(1), (link + cross).sum(0)) \
        * row_bytes
    return (float(max(hbm.max(), k_link.max() / NVLINK_BYTES_PER_S)) * 1e3,
            float(x_link.max() / NVLINK_BYTES_PER_S) * 1e3,
            float(max(hbm.max(), both.max() / NVLINK_BYTES_PER_S)) * 1e3)


def phase_nodes_exchange(exchange):
    """The exchange alone at phase 7's shapes (4 senders of [4, 2^24, 2],
    phase 7's counts), four processes, one card each, in two emulated
    nodes: bit-exact, the on-node kernel's and the NCCL leg's CUDA events
    apart, each against its bound, each node's span, no cross-node IPC
    open (mean of 10 exchanges after one)."""
    res, rcs, logs = _run_bench(_IPC_BENCH, "mn_bench", 4, str(ROOT),
                                MN_NODES)
    for pid, (rc, text) in enumerate(zip(rcs, logs)):
        if rc:
            raise SystemExit(f"phase 20: exchange bench process {pid} exited "
                             f"{rc}:\n{text[-3000:]}")
    if not all(r["ok"] for r in res):
        raise SystemExit("phase 20: the two-leg exchange delivered rows that "
                         "differ from the senders'")
    if [r["launches"] for r in res] != [11] * 4 or any(
            r["opens"] for r in res):
        raise SystemExit(f"phase 20: exchange bench launches "
                         f"{[r['launches'] for r in res]} (one a card an "
                         f"exchange: 11), cross-node IPC opens "
                         f"{[r['opens'] for r in res]}")
    rng = np.random.default_rng(2)
    n_rows = rng.integers(0, (1 << 24) + 1, size=(4, 4))
    n_rows[0, 1], n_rows[1, 2], n_rows[2, 3] = 0, 1 << 24, 12345
    kb, nb, bb = _node_bounds(n_rows, MN_NODES.split(","), 8)
    kernel = [float(np.mean(r["ms"])) for r in res]
    nccl = [float(np.mean(r["nccl_ms"])) for r in res]
    # a leg's time: its slowest rank's in each exchange (the bounds are
    # the busiest card's), mean of the exchanges
    kernel_leg = float(np.mean(np.max([r["ms"] for r in res], axis=0)))
    nccl_leg = float(np.mean(np.max([r["nccl_ms"] for r in res], axis=0)))
    init_s = [r["nccl_init_s"] for r in res]
    warmup_s = [r["nccl_warmup_s"] for r in res]
    spans = _node_spans(res)
    cross = sum(r["cross_bytes"] for r in res)
    x2 = exchange[2]
    log(f"[phase 20] two-leg exchange, 4 processes in 2 emulated nodes, 4 x "
        f"[4, 2^24, 2]: bit-exact, one launch a card, 0 cross-node IPC "
        f"opens; on-node kernel by CUDA events {[round(e, 4) for e in kernel]}"
        f" ms, the leg (slowest rank) {kernel_leg:.4f} ms (bound_ms "
        f"{kb:.4f}); NCCL leg by its stream's CUDA events "
        f"{[round(e, 4) for e in nccl]} ms, the leg (slowest rank) "
        f"{nccl_leg:.4f} ms for {cross} bytes sent across nodes (bound_ms "
        f"{nb:.4f} at NVLink's 450 GB/s, one machine: not an InfiniBand "
        f"figure); span by node (host clock, mean of 10) "
        f"{ {n: round(v, 4) for n, v in spans.items()} } ms; both legs' "
        f"bound_ms {bb:.4f}; one process on one card (phase 7) "
        f"{x2['ms']:.4f} ms; the NCCL group's communicator by rank "
        f"{[round(t, 4) for t in init_s]} s, its cross-node pairs' warm-up "
        f"{[round(t, 4) for t in warmup_s]} s (host clock, first exchange)")
    return dict(kernel_ms=kernel, kernel_leg_ms=kernel_leg,
                kernel_bound_ms=kb, nccl_ms=nccl, nccl_leg_ms=nccl_leg,
                nccl_bound_ms=nb, bound_ms=bb, spans=spans, cross_bytes=cross,
                nccl_init_s=init_s, nccl_warmup_s=warmup_s)


# Whether NCCL point-to-point carries a process whose shards sit on two
# cards (the layout check_node_layout refuses across nodes): two
# processes of two cards each, one batch_isend_irecv from both of a
# process's cards; the outcome, and nothing of the port.
_NCCL_TWO_CARDS = r"""
import json, os, sys
from datetime import timedelta
import torch
import torch.distributed as dist

init, n_procs, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "1"
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                        timeout=timedelta(seconds=30))
cards = [torch.device("cuda", 2 * rank + i) for i in range(2)]
torch.cuda.set_device(cards[0])
result = {}
try:
    g = dist.new_group(backend="nccl", timeout=timedelta(seconds=30))
    x = torch.ones(1, device=cards[0])
    dist.all_reduce(x, group=g)
    bufs = [torch.full((1 << 20,), 10 * rank + i, dtype=torch.int32,
                       device=d) for i, d in enumerate(cards)]
    ops = [dist.P2POp(dist.isend if rank == 0 else dist.irecv, b, 1 - rank,
                      g) for b in bufs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for d in cards:
        torch.cuda.synchronize(d)
    result["ok"] = rank == 0 or all(
        bool((b == i).all()) for i, b in enumerate(bufs))
except Exception as e:
    result = {"ok": False, "error": f"{type(e).__name__}: {e}"[:600]}
json.dump(result, open(out, "w"))
"""


def phase_nodes_two_cards():
    res, rcs, logs = _run_bench(_NCCL_TWO_CARDS, "mn_two_cards", 2,
                                timeout=120)
    works = all(r and r["ok"] for r in res)
    why = [r.get("error") if r else f"exit {rc}: {text[-300:]}"
           for r, rc, text in zip(res, rcs, logs)]
    log(f"[phase 20] NCCL point-to-point from a process holding two cards "
        f"(2 processes x 2 cards, one batch): "
        f"{'delivered' if works else 'refused or failed'}; {why}")
    return works


def phase_nodes(fq_mid, full, exchange):
    """Phase 20: counting across nodes, emulated as two nodes of two
    processes on one machine (MP_NODE); on fewer than four cards the same
    emulation on CPU shards."""
    if torch.cuda.device_count() < 4:
        return phase_nodes_cpu(fq_mid)
    mid = phase_nodes_mid(fq_mid)
    full_row = phase_nodes_full(full)
    bench = phase_nodes_exchange(exchange)
    two_cards = phase_nodes_two_cards()
    return dict(mid=mid, full=full_row, bench=bench, nccl=True,
                two_cards_a_process=two_cards)


def timed(n, fn, *args):
    """fn(*args), logged with its seconds as phase n."""
    t0 = time.perf_counter()
    result = fn(*args)
    log(f"[phase {n}] {time.perf_counter() - t0:.1f} s")
    return result


def phase_scan_and_ingest():
    """Phase 2: the scan entry, the fused ingest, its greedy entry and
    histogram output, one batch through the store.  Returns the scan's,
    the fused ingest's and the greedy entry's rows."""
    scan = phase_scan()
    fused = phase_ingest()
    greedy = phase_ingest_greedy()
    phase_store_ingest()
    return scan, fused, greedy


# The phases in order: (number, function, the phases whose results it
# takes).  Phase 1 (phase_card) always runs first.
PHASES = (
    (2, phase_scan_and_ingest, ()),
    (3, phase_sort, ()),
    (4, phase_card_vs_cpu, ()),
    (5, phase_full, ()),
    (6, phase_profile, (5,)),
    (7, phase_exchange, ()),
    (8, phase_sharded_mid, (4,)),
    (9, phase_sharded_full, (5,)),
    (10, phase_last_kernels, ()),
    (11, phase_spill_mid, (4,)),
    (12, phase_spill_full, ()),
    (13, phase_sharded_spill_full, (12,)),
    (14, phase_other_routes, (4, 5)),
    (15, phase_inputs_and_readers, (4, 5)),
    (16, phase_tools, (5,)),
    (17, phase_greedy, (4, 5)),
    (18, phase_sharded_modes, (4, 5)),
    (19, phase_multiprocess, (4, 5, 7)),
    (20, phase_nodes, (4, 5, 7)),
)


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    WORK.mkdir(exist_ok=True)
    only = {int(a) for a in argv}
    need = only | {dep for n, _, deps in PHASES if n in only for dep in deps}
    t_all = time.perf_counter()
    card = phase_card()
    got = {}
    for n, fn, deps in PHASES:
        if not only or n in need:
            got[n] = timed(n, fn, *(got[dep] for dep in deps))
    if only:  # a quick check: no kernels line, no ok line
        log(f"[done] phases {sorted(need)} passed")
        return 0
    (scan, fused, greedy), sort, exchange = got[2], got[3], got[7]
    greedy_run = got[17]  # phase 17's deferred full-size run
    modes = got[18]  # phase 18: the sharded modes and the SPMD step
    mp = got[19]  # phase 19: multi-process counting
    mn = got[20]  # phase 20: counting across (emulated) nodes
    mn_bench = mn.get("bench", {})
    step18 = modes["step"]["launches"]
    xs18 = modes["step"]["exchange"]
    sharded, (scan_1d, probes) = got[9], got[10]
    bucket_scans = got[14]  # the host-bucket route's scan-entry launches

    s27 = scan[(27, True)]
    f27 = fused[(27, "bounds")]  # the main path's feed
    s26 = sort[(1 << 26, 2)]
    x2 = exchange[2]  # the unit exchange of k <= 27 moves 2 words a row
    kernels = [
        {"name": "fused_ingest", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/extract.cu",
         "replaces": "kmc_tpu/ops/store.py:296",
         "launches": sharded["fused_ingest"],
         "max_abs_err": max(r["max_abs_err"] for r in
                            list(fused.values()) + list(greedy.values())),
         "ms": f27["ms"], "plain_ms": f27["plain_ms"],
         "bound_ms": f27["bound_ms"], "bound_by": f27["bound_by"],
         "library_ms": None, "stream_ms": f27["stream_ms"],
         # the greedy entry (phase 2 at m = 9 and 11; phase 17's eager run
         # launches it) and the histogram output (phase 17's deferred run)
         "greedy_replaces": "kmc_tpu/ops/store.py:307",
         "greedy_ms_m9": greedy[("greedy", 9)]["ms"],
         "greedy_plain_ms_m9": greedy[("greedy", 9)]["plain_ms"],
         "greedy_bound_ms_m9": greedy[("greedy", 9)]["bound_ms"],
         "greedy_stream_ms_m9": greedy[("greedy", 9)]["stream_ms"],
         "greedy_ms_m11": greedy[("greedy", 11)]["ms"],
         "greedy_plain_ms_m11": greedy[("greedy", 11)]["plain_ms"],
         "greedy_bound_ms_m11": greedy[("greedy", 11)]["bound_ms"],
         "greedy_stream_ms_m11": greedy[("greedy", 11)]["stream_ms"],
         "greedy_map_bytes_m11": greedy[("greedy", 11)]["table_bytes"],
         "hist_ms": greedy[("hist", 9)]["ms"],
         "hist_plain_ms": greedy[("hist", 9)]["plain_ms"],
         "hist_bound_ms": greedy[("hist", 9)]["bound_ms"],
         "hist_stream_ms": greedy[("hist", 9)]["stream_ms"],
         "greedy_path_launches": greedy_run["launches"]["fused_ingest"],
         "hist_launches": greedy_run["launches"]["hist"],
         "greedy_launches": greedy_run["eager_greedy"],
         # phase 18's full-size sharded greedy run (every ingest on the
         # greedy entry) and the sharded KFF run
         "sharded_greedy_launches":
             modes["full"]["greedy27"]["launches"]["greedy"],
         "sharded_kff_launches":
             modes["full"]["kff"]["launches"]["fused_ingest"]},
        {"name": "splitter_scan", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/extract.cu",
         "replaces": "kmc_tpu/ops/pallas_extract.py:312",
         "launches": bucket_scans,
         "max_abs_err": max(r["max_abs_err"] for r in scan.values()),
         "ms": s27["ms"], "plain_ms": s27["plain_ms"],
         "bound_ms": s27["bound_ms"], "bound_by": s27["bound_by"],
         "library_ms": None,
         # phase 18: the sharded greedy map's stage 0, the SPMD step
         "sharded_stage0_launches":
             modes["full"]["greedy27"]["launches"]["splitter_scan"],
         "step_launches": step18["splitter_scan"]},
        {"name": "radix_sort", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/radix_sort.cu",
         "replaces": "kmc_tpu/ops/pallas_sort.py:170",
         "launches": sharded["radix_sort"],
         "max_abs_err": max(r["max_abs_err"] for r in sort.values()),
         "ms": s26["ms"], "plain_ms": s26["plain_ms"],
         "bound_ms": s26["bound_ms"], "bound_by": "bytes",
         "library_ms": s26["library_ms"],
         # phase 17's deferred greedy run: all its sorts, the collect's
         "greedy_path_launches": greedy_run["launches"]["radix_sort"],
         "collect_launches": greedy_run["collect"],
         "sharded_modes_launches": {
             name: row["launches"]["radix_sort"]
             for name, row in modes["full"].items()},
         "step_launches": step18["radix_sort"]},
        {"name": "ragged_all_to_all", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/ragged_a2a.cu",
         "replaces": "kmc_tpu/parallel/pallas_a2a.py:164",
         "launches": sharded["ragged_all_to_all"],
         "max_abs_err": max(r["max_abs_err"] for r in exchange.values()),
         "ms": x2["ms"], "plain_ms": x2["plain_ms"],
         "bound_ms": x2["bound_ms"], "bound_by": "bytes",
         "library_ms": x2["library_ms"],
         "sharded_modes_launches": {
             name: row["launches"]["ragged_all_to_all"]
             for name, row in modes["full"].items()},
         # phase 7 on distinct cards (one process; null on one card): the
         # host clock around whole exchanges against the NVLink bound
         "phase7_busy_ms": x2["busy_ms"],
         "phase7_after_idle_ms": x2["after_idle_ms"],
         "cross_card_ms": exchange.get("cross", {}).get("ms"),
         "cross_card_bound_ms": exchange.get("cross", {}).get("bound_ms"),
         # phase 19: the same kernel across processes (one launch a card
         # by its lowest rank; other processes' buffers opened through
         # CUDA IPC): each rank's launches in the full-size multi-process
         # count, the exchange's time there and at phase 7's shapes, each
         # against the bytes' bound, with the launch skew between the
         # processes (times: the host clock from the first launching
         # process's launch to the last one's synchronize)
         "ipc_launches": mp["full"]["launches"],
         "ipc_full_ms": mp["full"]["ms"],
         "ipc_full_event_ms": mp["full"]["event_ms"],
         "ipc_full_skew_ms": mp["full"]["skew_ms"],
         "ipc_full_bound_ms": mp["full"]["bound_ms"],
         "ipc_ms": mp["bench"]["ms"], "ipc_bound_ms": mp["bench"]["bound_ms"],
         "ipc_event_ms": mp["bench"]["event_ms"],
         "ipc_skew_ms": mp["bench"]["skew_ms"],
         # the library call across processes: NCCL's all_to_all_single of
         # the same rows over four cards (null where NCCL refused the
         # layout: the note says why)
         "ipc_library_ms": mp["bench"]["nccl_ms"],
         "ipc_library_event_ms": mp["bench"]["nccl_event_ms"],
         "ipc_library_note": mp["bench"]["nccl_note"],
         # phase 20: the exchange across two emulated nodes of two
         # processes, one card each (null on fewer than four cards: the
         # NCCL leg needs cards of their own): each rank's launches in the
         # full-size count; at phase 7's shapes the on-node kernel's and
         # the NCCL leg's time (the slowest rank's CUDA events) each
         # against its bound (the busiest card's; NVLink's for the NCCL
         # leg: the nodes share one machine), the same by rank, each
         # node's span on the host clock, and the NCCL group's
         # communicator and warm-up seconds by rank
         "nodes_launches": mn.get("full", {}).get("launches"),
         "nodes_kernel_ms": mn_bench.get("kernel_leg_ms"),
         "nodes_kernel_bound_ms": mn_bench.get("kernel_bound_ms"),
         "nodes_kernel_ms_by_rank": mn_bench.get("kernel_ms"),
         "nodes_nccl_ms": mn_bench.get("nccl_leg_ms"),
         "nodes_nccl_bound_ms": mn_bench.get("nccl_bound_ms"),
         "nodes_nccl_ms_by_rank": mn_bench.get("nccl_ms"),
         "nodes_nccl_init_s": mn_bench.get("nccl_init_s"),
         "nodes_nccl_warmup_s": mn_bench.get("nccl_warmup_s"),
         "nodes_span_ms": mn_bench.get("spans"),
         "nodes_bound_ms": mn_bench.get("bound_ms")},
        {"name": "all_to_all", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/ragged_a2a.cu",
         "replaces": "kmc_tpu/parallel/pallas_a2a.py:222",
         # the SPMD count step's exchange and its times at the step's
         # shapes (phase 18); phase 7's at [4, 2^24, 2] beside them
         "launches": step18["all_to_all"],
         "max_abs_err": max([xs18["max_abs_err"]] + [
             r["max_abs_err"] for r in exchange.values()]),
         "ms": xs18["ms"], "plain_ms": xs18["plain_ms"],
         "bound_ms": xs18["bound_ms"], "bound_by": "bytes",
         "library_ms": xs18["library_ms"],
         "phase7_ms": x2["dense_ms"], "phase7_plain_ms": x2["dense_plain_ms"],
         "phase7_bound_ms": x2["dense_bound_ms"],
         "phase7_library_ms": x2["library_ms"],
         "step_device_ms_a_round": modes["step"]["device_ms"]},
    ]
    s1d = scan_1d[(27, True)]
    kernels.append(
        {"name": "splitter_scan_1d", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/extract.cu",
         "replaces": "kmc_tpu/ops/pallas_extract.py:160",
         "launches": s1d["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in scan_1d.values()),
         "ms": s1d["ms"], "plain_ms": s1d["plain_ms"],
         "bound_ms": s1d["bound_ms"], "bound_by": s1d["bound_by"],
         "library_ms": None})
    for name, line in (("probe_add1", 131), ("probe_gather_rows", 150),
                       ("probe_gather_lanes", 174)):
        p = probes[name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "kmc_tpu_torch/csrc/probes.cu",
             "replaces": f"tools/microbench_sort.py:{line}",
             "launches": p["launches"], "max_abs_err": p["max_abs_err"],
             "ms": p["ms"], "plain_ms": p["plain_ms"],
             "bound_ms": p["bound_ms"], "bound_by": "bytes",
             "library_ms": p["library_ms"]})
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(f"card: {card}")  # again, near the end of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
