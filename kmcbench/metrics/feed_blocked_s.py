"""feed_blocked_s: seconds a job of the sharded count in which its feed
thread (kmc-ingest-feed: parse, batches, packing for every shard) waits
to put a packed group into the full queue: the program's kmc.feed_put
spans; the median over the profiled jobs.  Near 0 the feed sets the
pace, and the cards wait on it; high, the cards' ingest does.

A program whose feed counts its batches (the "batches" counter of
kmc.ingest_feed) and recorded no kmc.feed_put reads 0; a program without
those counters, as before they were added, or a cell of one card, reads
nothing."""

import statistics

from kmcbench import spans


def read(run):
    secs = [j.seconds("kmc.feed_put") for j in spans.profiled_jobs(run)
            if any("batches" in (s.counters or {})
                   for s in j.named("kmc.ingest_feed"))]
    return statistics.median(secs) if secs else None
