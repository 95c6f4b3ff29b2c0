"""device_idle_parse_pct: the share of a profiled job's wall time in
which no kernel, memcpy or memset ran on the card while the counting
thread's innermost program span was kmc.parse_wait (waiting on the
reader pool for parsed input), in %; the program's spans mapped onto the
device trace's clock by each job's window (kmcbench/spans.py); the mean
over the profiled jobs."""

from kmcbench import spans


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    busy = spans.device_busy(run)
    shares = []
    for j in spans.profiled_jobs(run):
        if j.window is None:
            continue
        idle = sum(spans.idle_us(busy, j.to_trace_us(a), j.to_trace_us(b))
                   for a, b, name in j.innermost()
                   if name == "kmc.parse_wait")
        shares.append(100.0 * idle / (j.window[1] - j.window[0]))
    return spans.mean(shares)
