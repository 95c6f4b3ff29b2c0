"""kmers_per_s: the k-mers the window's jobs counted (the sum of their
n_total_kmers) over the window's seconds, host clock: a user's wall time
per sample."""


def read(run):
    if not run.ok_jobs or run.window_s <= 0:
        return None
    return sum(j.stats["n_total"] for j in run.ok_jobs) / run.window_s
