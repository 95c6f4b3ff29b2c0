"""shard_ingest_s: seconds a job of the sharded count spends in its
stage-1 ingest loop, the feed thread's parse and packing and every
shard's ingest and compactions: the program's kmc.ingest span
(distributed_count's "ingest_wall_s" timing); the median over the
window's jobs.  Nothing to read in a cell of one card."""

import statistics


def read(run):
    secs = [j.timings["ingest_wall_s"] for j in run.ok_jobs if j.timings]
    return statistics.median(secs) if secs else None
