#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kmc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase (the contract's run)
    python3 chip_smoke.py 2 6        # phase 1, the phases named and those
                                     # whose results they take (PHASES)
    python3 chip_smoke.py 14         # the other routes (with phases 4, 5)

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
     own SASS instructions per position take;
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
     version: 4 shards, segments of 2^24 rows, 2 and 3 words a row;
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
     at MB_LOGN = 26;
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
     scan entry, both the sort) and its peak device memory.
Then a {"kernels": [...]} line with each kernel's launches on its path
(phase 9 for the sharded path's kernels, the fused ingest among them; the
dense all-to-all, which no path calls, from phase 7; the 2-D scan entry
from phase 14's full-size host-bucket run, the 1-D entry and the probes
from their own entries in phase 10) and its times from phases 2, 3, 7 and
10.  Every device-store path must ingest through the fused kernel and
never through the scan entry.  Shards sit on distinct cards when the machine has two or more,
else all on card 0.  The last line is {"ok": true, "device": {...}}.
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
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _build.build_all(verbose=True)
    log(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


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


def _profiled_device(fn, reps):
    """(device ms, device items) per call of fn, summed over the kernel,
    copy and memset spans that torch.profiler saw in reps calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    if not dev:
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
                    row = dict(
                        max_abs_err=err,
                        ms=dev_ms, stream_ms=cuda_ms(kernel, 20),
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


def write_fastq(path: Path, genome_len: int, coverage: int, seed: int):
    """bench.py's synthetic reads: a random genome, reads of 150 bp at
    uniform starts, written in blocks."""
    read_len = 150
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_reads = genome_len * coverage // read_len
    starts = rng.integers(0, genome_len - read_len, n_reads)
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
        outs, rr = ragged_all_to_all(xs, n_rows)
        ref, rr_ref = ragged_all_to_all_plain(xs, n_rows)
        torch.cuda.synchronize()
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
        phase_exchange_cross_cards()
    return rows


def phase_exchange_cross_cards():
    """The exchange with each shard on its own card (peer reads over
    NVLink): bit-exact against the plain version, timed on the host clock
    around whole exchanges (events do not span cards)."""
    from kmc_tpu_torch.parallel.exchange_kernel import (
        ragged_all_to_all, ragged_all_to_all_plain)

    devices = shard_devices()
    D, cap, C = len(devices), 1 << 24, 2
    xs = [torch.randint(-2**31, 2**31 - 1, (D, cap, C), dtype=torch.int32,
                        device=d) for d in devices]
    n_rows = np.random.default_rng(7).integers(0, cap + 1, size=(D, D))
    outs, rr = ragged_all_to_all(xs, n_rows)
    ref, _ = ragged_all_to_all_plain(xs, n_rows)
    _sync_all()
    for r in range(D):
        for j in range(D):
            m = int(rr[r, j])
            if not torch.equal(outs[r][j, :m], ref[r][j, :m]):
                raise SystemExit(f"phase 7: cross-card exchange owner {r} "
                                 f"sender {j} differs from plain")
    del outs, ref

    def host_ms(fn, reps):
        fn()
        _sync_all()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync_all()
        return (time.perf_counter() - t0) / reps * 1e3

    row_b = 4 * C
    peer = n_rows * (1 - np.eye(D, dtype=np.int64))  # rows crossing cards
    link_b = max(peer.sum(0).max(), peer.sum(1).max()) * row_b
    ms = host_ms(lambda: ragged_all_to_all(xs, n_rows), 10)
    plain_ms = host_ms(lambda: ragged_all_to_all_plain(xs, n_rows), 3)
    log(f"[phase 7] cross-card exchange on {devices}, cap=2^24 C={C}: "
        f"bit-exact; {int(n_rows.sum())} rows, {int(peer.sum()) * row_b} "
        f"bytes over NVLink (busiest link direction {int(link_b)} bytes); "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} (host clock) "
        f"bound_ms {link_b / NVLINK_BYTES_PER_S * 1e3:.4f} (450 GB/s each "
        "way)")
    del xs
    for d in devices:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def _same_db(a: Path, b: Path) -> bool:
    return all((a.parent / (a.name + suf)).read_bytes()
               == (b.parent / (b.name + suf)).read_bytes()
               for suf in (".kmc_pre", ".kmc_suf"))


def run_sharded(fq, out, devices, **kw):
    from kmc_tpu_torch import distributed_count

    t0 = time.perf_counter()
    stats = distributed_count([str(fq)], str(out), k=27, cutoff_min=2,
                              devices=devices, **kw)
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


def timed(n, fn, *args):
    """fn(*args), logged with its seconds as phase n."""
    t0 = time.perf_counter()
    result = fn(*args)
    log(f"[phase {n}] {time.perf_counter() - t0:.1f} s")
    return result


def phase_scan_and_ingest():
    """Phase 2: the scan entry, the fused ingest, one batch through the
    store.  Returns the scan's and the fused ingest's rows."""
    scan = phase_scan()
    fused = phase_ingest()
    phase_store_ingest()
    return scan, fused


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
    phase_card()
    got = {}
    for n, fn, deps in PHASES:
        if not only or n in need:
            got[n] = timed(n, fn, *(got[dep] for dep in deps))
    if only:  # a quick check: no kernels line, no ok line
        log(f"[done] phases {sorted(need)} passed")
        return 0
    (scan, fused), sort, exchange = got[2], got[3], got[7]
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
         "max_abs_err": max(r["max_abs_err"] for r in fused.values()),
         "ms": f27["ms"], "plain_ms": f27["plain_ms"],
         "bound_ms": f27["bound_ms"], "bound_by": f27["bound_by"],
         "library_ms": None},
        {"name": "splitter_scan", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/extract.cu",
         "replaces": "kmc_tpu/ops/pallas_extract.py:312",
         "launches": bucket_scans,
         "max_abs_err": max(r["max_abs_err"] for r in scan.values()),
         "ms": s27["ms"], "plain_ms": s27["plain_ms"],
         "bound_ms": s27["bound_ms"], "bound_by": s27["bound_by"],
         "library_ms": None},
        {"name": "radix_sort", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/radix_sort.cu",
         "replaces": "kmc_tpu/ops/pallas_sort.py:170",
         "launches": sharded["radix_sort"],
         "max_abs_err": max(r["max_abs_err"] for r in sort.values()),
         "ms": s26["ms"], "plain_ms": s26["plain_ms"],
         "bound_ms": s26["bound_ms"], "bound_by": "bytes",
         "library_ms": s26["library_ms"]},
        {"name": "ragged_all_to_all", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/ragged_a2a.cu",
         "replaces": "kmc_tpu/parallel/pallas_a2a.py:164",
         "launches": sharded["ragged_all_to_all"],
         "max_abs_err": max(r["max_abs_err"] for r in exchange.values()),
         "ms": x2["ms"], "plain_ms": x2["plain_ms"],
         "bound_ms": x2["bound_ms"], "bound_by": "bytes",
         "library_ms": x2["library_ms"]},
        {"name": "all_to_all", "route": "cuda",
         "source": "kmc_tpu_torch/csrc/ragged_a2a.cu",
         "replaces": "kmc_tpu/parallel/pallas_a2a.py:222",
         "launches": x2["dense_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in exchange.values()),
         "ms": x2["dense_ms"], "plain_ms": x2["dense_plain_ms"],
         "bound_ms": x2["dense_bound_ms"], "bound_by": "bytes",
         "library_ms": x2["library_ms"]},
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
