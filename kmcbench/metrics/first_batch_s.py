"""first_batch_s: seconds from a job's stage 1 start (kmc.stage1) to its
first ingest launch (kmc.ingest_launch): the set-up, the input split and
the first chunk's read, parse and packing before the card has work; the
mean over the profiled jobs."""

from kmcbench import spans


def read(run):
    firsts = []
    for j in spans.profiled_jobs(run):
        launches = j.named("kmc.ingest_launch")
        if launches:
            first = min(s.start for s in launches)
            firsts.append((first - j.stage1.start) / 1e9)
    return spans.mean(firsts)
