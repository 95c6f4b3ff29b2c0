"""shard_compact_s: seconds a job of the sharded count spends in its
store-wide compactions, every shard's grouping sort issued on its card
before the host waits on any: the program's kmc.shard_compact spans,
summed a job; the median over the profiled jobs.  A cell of one card, or
a program without the span, as before it was added, reads nothing."""

import statistics

from kmcbench import spans


def read(run):
    jobs = spans.profiled_jobs(run)
    if not any(j.named("kmc.shard_compact") for j in jobs):
        return None
    return statistics.median(j.seconds("kmc.shard_compact") for j in jobs)
