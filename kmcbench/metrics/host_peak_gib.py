"""host_peak_gib: the highest resident set of the process during any job
of the window (VmHWM reset before each job), in GiB: the host RAM a
user sizes a machine by, against the -m budget."""


def read(run):
    if not run.jobs:
        return None
    return max(j.host_peak_bytes for j in run.jobs) / 2**30
