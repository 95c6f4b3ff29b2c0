"""Where a traced run's time goes, by the program's own spans: one
traced run of a cell (the benchmark's run, --trace 1), then

  * per profiled job, the program's host input (kmc.parse_wait,
    kmc.assemble, kmc.pack, then with the pool's start, kmc.split and
    kmc.reader_start) against the benchmark's host_input span,
    kmc.stage2 against Stage2Results.time, the spill_stats times against
    their spans, and kmc.stage1's start mapped onto the device trace
    against the benchmark's stage1 span there;
  * the profiled jobs' device idle by the counting thread's innermost
    program span, and the share of it some kmc.* span other than
    kmc.stage1 / kmc.stage2 covers;
  * the device's copies (count, bytes, device seconds) by kind and by
    the innermost program span open on the thread that issued them.

    python -m kmcbench.breakdown --workload <cell> --seed <n> --out <file.json>
        [--seconds 51]

Prints a summary on standard error and writes everything as JSON.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

from kmcbench import devtrace, harness, spans

BOTH = ("kmc.stage1", "kmc.stage2")


class _Saved:
    """A profile already exported: writes its trace again."""

    def __init__(self, text):
        self.text = text

    def export_chrome_trace(self, path):
        Path(path).write_text(self.text)


def _capture():
    """Keeps the run the readers see and the raw device trace."""
    got = {}
    load, read = harness.load_reader, devtrace.read

    def load_reader(name, root=harness.ROOT):
        mod = load(name, root)
        real = mod.read

        def keep(run):
            got["run"] = run
            return real(run)
        mod.read = keep
        return mod

    def read_trace(prof, path, host_names):
        prof.export_chrome_trace(str(path))  # a trace saves only once
        text = Path(path).read_text()
        got["events"] = json.loads(text)["traceEvents"]
        return read(_Saved(text), path, host_names)

    harness.load_reader = load_reader
    devtrace.read = read_trace
    return got


def _copies(events):
    """Device copies by kind and by the innermost kmc.* annotation open on
    the issuing thread when the copy's op ran.  The op (a cpu_op of the
    same External id as the runtime call) names the thread: a runtime
    call of a thread started after the first may carry another thread's
    id."""
    marks = defaultdict(list)  # tid -> [(start, end, name)]
    calls = {}  # correlation -> (tid, ts)
    ops = {}  # External id -> (tid, ts)
    for e in events:
        if "dur" not in e:
            continue
        cat, args = e.get("cat"), e.get("args", {})
        if cat == "user_annotation" and e["name"].startswith("kmc."):
            marks[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat == "cpu_op" and "External id" in args:
            ops[args["External id"]] = (e["tid"], e["ts"])
    for e in events:
        args = e.get("args", {})
        if e.get("cat") == "cuda_runtime" and "correlation" in args:
            calls[args["correlation"]] = ops.get(args.get("External id"),
                                                 (e["tid"], e["ts"]))
    for v in marks.values():
        v.sort()
    table = defaultdict(lambda: [0, 0, 0.0])  # (kind, span) -> n, B, s
    for e in events:
        if e.get("cat") != "gpu_memcpy" or "dur" not in e:
            continue
        args = e.get("args", {})
        tid, ts = calls.get(args.get("correlation"), (None, None))
        name = "none"
        if tid is not None:
            ms = marks.get(tid, [])
            open_ = [m for m in ms[:bisect.bisect_right(ms, (ts, float("inf")))]
                     if m[1] >= ts]
            if open_:
                name = max(open_)[2]
        row = table[e["name"], name]
        row[0] += 1
        row[1] += int(args.get("bytes", 0))
        row[2] += e["dur"] / 1e6
    return [[k, s, n, b, t] for (k, s), (n, b, t) in
            sorted(table.items(), key=lambda x: -x[1][2])]


def _idle_by_span(run, jobs):
    busy = spans.device_busy(run)
    by = defaultdict(float)
    total = 0.0
    for j in jobs:
        pieces = j.innermost()
        lo, hi = j.window
        total += spans.idle_us(busy, lo, hi)
        at = lo
        for a, b, name in pieces:
            a, b = max(j.to_trace_us(a), lo), min(j.to_trace_us(b), hi)
            if b <= a:
                continue
            if a > at:
                by["none"] += spans.idle_us(busy, at, a)
            by[name] += spans.idle_us(busy, a, b)
            at = b
        if hi > at:
            by["none"] += spans.idle_us(busy, at, hi)
    covered = sum(v for k, v in by.items() if k not in BOTH and k != "none")
    return ({k: v / 1e6 for k, v in sorted(by.items(), key=lambda x: -x[1])},
            total / 1e6, covered / total if total else None)


def _per_job(run, jobs, events):
    stage1 = sorted(a for n, a, _ in run.trace.host if n == "stage1")
    marked = sorted(e["ts"] for e in events if e.get("name") == "kmc.stage1"
                    and e.get("cat") == "user_annotation")
    busy = spans.device_busy(run)
    out = []
    for j in jobs:
        job = j.job
        prog = sum(j.seconds(n) for n in
                   ("kmc.parse_wait", "kmc.assemble", "kmc.pack"))
        start = j.seconds("kmc.split") + j.seconds("kmc.reader_start")
        host = run.probes.spans["host_input"].get(job.index, 0.0)
        probe = min(stage1, key=lambda a: abs(a - j.window[0]))
        # kmc.stage1's own annotation against its start mapped by the
        # window's start, its end and their mean
        mark = min(marked, key=lambda a: abs(a - j.window[0]), default=None)
        t = j.stage1.start / 1e3
        by_start = j.window[0] + t - job.start * 1e6
        by_end = j.window[1] + t - job.end * 1e6
        st = job.spill or {}
        out.append(dict(
            job=job.index, wall_s=job.wall_s, host_input_s=host,
            program_host_input_s=prog,
            host_input_ratio=prog / host if host else None,
            with_pool_start_ratio=(prog + start) / host if host else None,
            stage2_span_s=j.seconds("kmc.stage2"),
            stage2_result_s=job.stage2_s,
            t_spill_d2h=[st.get("t_spill_d2h"),
                         j.seconds("kmc.spill_wait")
                         + j.seconds("kmc.spill_d2h")],
            t_remerge=[st.get("t_remerge"), j.seconds("kmc.remerge")],
            t_host_merge=[st.get("t_host_merge"),
                          j.seconds("kmc.host_merge")],
            stage1_mapped_minus_probe_ms=(
                j.to_trace_us(j.stage1.start) - probe) / 1e3,
            map_error_ms=None if mark is None else dict(
                start=(by_start - mark) / 1e3, end=(by_end - mark) / 1e3,
                mean=((by_start + by_end) / 2 - mark) / 1e3),
            seconds={n: j.seconds(n) for n in sorted({s.name
                                                      for s in j.spans})},
            counters=_counters(j),
            timeline=_timeline(j, busy)))
    return out


def _counters(j) -> dict:
    """Calls and counter sums by span name."""
    out = defaultdict(lambda: defaultdict(float))
    for s in j.spans:
        out[s.name]["calls"] += 1
        for k, v in (s.counters or {}).items():
            out[s.name][k] += v
    return {n: dict(c) for n, c in sorted(out.items())}


def _timeline(j, busy, min_ms=0.5) -> list:
    """The counting thread's pieces of at least min_ms: (ms from
    kmc.stage1's start, ms, innermost span, ms of it the device idled),
    and the other threads' spans of at least 5 ms (ms, ms, name, thread
    index)."""
    t0 = j.stage1.start
    rows = [[(a - t0) / 1e6, (b - a) / 1e6, n,
             spans.idle_us(busy, j.to_trace_us(a), j.to_trace_us(b)) / 1e3]
            for a, b, n in j.innermost() if b - a >= min_ms * 1e6]
    threads = {}
    for s in sorted(j.spans, key=lambda s: s.start):
        if s.thread != j.thread and s.end - s.start >= 5e6:
            tid = threads.setdefault(s.thread, len(threads) + 1)
            rows.append([(s.start - t0) / 1e6, (s.end - s.start) / 1e6,
                         s.name, f"thread {tid}"])
    return sorted(rows, key=lambda r: r[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    got = _capture()
    result = harness.run_cell(harness.load_cell(args.workload), args.seed,
                              args.seconds, True)
    run = got["run"]
    jobs = [j for j in spans.profiled_jobs(run) if j.window is not None]
    idle, idle_s, covered = _idle_by_span(run, jobs)
    out = dict(workload=args.workload, seed=args.seed, card=harness.card_line(),
               correct=result["correct"], metrics=result["metrics"],
               per_job=_per_job(run, jobs, got.get("events", [])),
               idle_by_span_s=idle,
               idle_s=idle_s, idle_covered_share=covered,
               copies=_copies(got.get("events", [])))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    log(f"breakdown of {args.workload} seed {args.seed}: correct "
        f"{result['correct']}; metrics " + ", ".join(
            f"{k} {v['value']:.6g}" for k, v in result["metrics"].items()))
    for row in out["per_job"]:
        log("job " + ", ".join(f"{k} {v}" for k, v in row.items()
                               if k not in ("seconds", "counters",
                                            "timeline")))
    log(f"device idle {idle_s:.4f} s in {len(jobs)} jobs, covered by kmc.* "
        f"spans {covered}; by innermost span: "
        + ", ".join(f"{k} {v:.4f}" for k, v in idle.items()))
    for kind, name, n, b, t in out["copies"]:
        log(f"copy {kind} under {name}: {n} copies, {b} bytes, {t:.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
