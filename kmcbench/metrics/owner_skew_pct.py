"""owner_skew_pct: how far the sharded finalize's fullest owner is past
the mean owner, in %: each owner's "rows" counter of its kmc.owner span
(the rows it received and sorted, inside kmc.owner_sort), the fullest
over the mean, less 1; the median over the profiled jobs.  The owner
plan (kmc.owner_hist) splits the bins by load, so it reads near 0 where
the plan balances the owners.  Nothing to read in a cell of one card, or
from a program without the owners' spans."""

import statistics

from kmcbench import spans


def read(run):
    skews = []
    for j in spans.profiled_jobs(run):
        rows = [(s.counters or {}).get("rows", 0) for s in j.named("kmc.owner")]
        if len(rows) > 1 and sum(rows):
            skews.append(100.0 * (max(rows) * len(rows) / sum(rows) - 1.0))
    return statistics.median(skews) if skews else None
