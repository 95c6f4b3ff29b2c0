"""parse_wait_s: seconds a job that the counting thread waits on the
reader pool for its next parsed chunk (the program's kmc.parse_wait
spans); the mean over the profiled jobs."""

from kmcbench import spans


def read(run):
    return spans.mean(j.seconds("kmc.parse_wait")
                      for j in spans.profiled_jobs(run))
