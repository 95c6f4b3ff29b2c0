"""host_input_s: seconds a job that the producer spends in host input:
the batches' parse and assembly (io/readers.py, io/native.py) and the
pack calls (pack_codes_boundaries / pack_codes_fused), from the probes'
"host_input" spans; the mean over the window's jobs."""


def read(run):
    if run.probes is None or not run.jobs:
        return None
    secs = run.probes.per_job(run.probes.spans, "host_input",
                              [j.index for j in run.jobs])
    return sum(secs) / len(secs) if any(secs) else None
