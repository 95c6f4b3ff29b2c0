"""stage1_sys_cpu_s: system CPU seconds a job that the count's own
threads spend in stage 1: the sys_s counters (RUSAGE_THREAD) of
kmc.stage1 on the counting thread and of the outermost span of each
thread it started (the ingest worker, the reader pool), so the harness's
threads stay out; the mean over the profiled jobs."""

from kmcbench import spans


def _thread_root(s) -> bool:
    return s.parent is None or s.parent.thread != s.thread


def read(run):
    jobs = spans.profiled_jobs(run)
    if not any("sys_s" in (j.stage1.counters or {}) for j in jobs):
        return None
    return spans.mean(
        sum((s.counters or {}).get("sys_s", 0.0) for s in j.spans
            if _thread_root(s) and j.under_stage1(s))
        for j in jobs)
