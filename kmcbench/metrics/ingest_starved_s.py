"""ingest_starved_s: seconds a job that the ingest worker, which feeds
the card, waits on an empty queue for the host's next batch (the
program's kmc.queue_get spans); the mean over the profiled jobs."""

from kmcbench import spans


def read(run):
    return spans.mean(j.seconds("kmc.queue_get")
                      for j in spans.profiled_jobs(run))
