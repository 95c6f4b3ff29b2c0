"""host_completer_s: seconds a job in the host route's completer (the
program's kmc.host_completer spans: the card's completer on each merged
key range and the copy of its records to the host; the NumPy completer
under a deferred greedy map), after the merge of the spilled runs; the
mean over the profiled jobs.  Nothing to read where no job took the host
route."""

from kmcbench import spans


def read(run):
    jobs = spans.profiled_jobs(run)
    if not any(j.named("kmc.host_completer") for j in jobs):
        return None
    return spans.mean(j.seconds("kmc.host_completer") for j in jobs)
