"""exchange_s: seconds a job of the sharded count spends in its
finalize's exchange and the owners' grouping sort: the program's
kmc.exchange and kmc.owner_sort spans, which distributed_count returns
summed as its "exchange_groupsort_s" timing; the median over the
window's jobs.  Nothing to read in a cell of one card."""

import statistics


def read(run):
    secs = [j.timings["exchange_groupsort_s"] for j in run.ok_jobs
            if j.timings]
    return statistics.median(secs) if secs else None
