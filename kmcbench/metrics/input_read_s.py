"""input_read_s: seconds a job that the busiest thread of the reader pool
spends reading its input: the read_s counters of the program's kmc.parse
spans (a chunk's reads, timed in C around each piece's read), summed on
each thread, the largest of those sums a job; the mean over the
profiled jobs.  The pool's threads read at once, so the busiest one's
reads lie on the job's path where a sum over the threads would not.  A
gzip file's reads are its inflate, a BGZF file's the Python reader
called back for each piece (its waits for the interpreter lock and its
copies included), a plain file's the page cache's reads.  A program
whose parse spans carry no read_s, as before the reads moved into C,
reads nothing."""

from collections import defaultdict

from kmcbench import spans


def _read_s(job) -> float:
    by_thread = defaultdict(float)
    for s in job.named("kmc.parse"):
        by_thread[s.thread] += (s.counters or {}).get("read_s", 0.0)
    return max(by_thread.values(), default=0.0)


def read(run):
    jobs = spans.profiled_jobs(run)
    if not any("read_s" in (s.counters or {})
               for j in jobs for s in j.named("kmc.parse")):
        return None
    return spans.mean(_read_s(j) for j in jobs)
