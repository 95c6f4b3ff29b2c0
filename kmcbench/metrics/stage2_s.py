"""stage2_s: Stage2Results.time, the store's finalize (spill replay or
the host route, the completer) and the KMC2 writer; the mean over the
window's jobs."""


def read(run):
    jobs = run.ok_jobs
    return sum(j.stage2_s for j in jobs) / len(jobs) if jobs else None
