"""spill_s: seconds a job in the store's spill and merges, from
Runner.spill_stats: the spills' device-to-host copies, the re-merges and
the host route's merge (t_spill_d2h + t_remerge + t_host_merge); the
mean over the window's jobs.  Nothing to read where no job spilled or
took the host route."""


def read(run):
    jobs = run.ok_jobs
    secs = [j.spill.get("t_spill_d2h", 0) + j.spill.get("t_remerge", 0)
            + j.spill.get("t_host_merge", 0) for j in jobs]
    if not any(secs):
        return None
    return sum(secs) / len(secs)
