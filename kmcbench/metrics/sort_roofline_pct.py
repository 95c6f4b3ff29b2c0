"""sort_roofline_pct: the grouping sort's share of its roofline over the
traced jobs: each radix_sort_columns call's bytes (roofline.sort_bytes:
every row's columns read once and written once) at the card's peak
memory rate, over the device time of its kernels, in %."""

from kmcbench import roofline

KERNELS = ("digit_histograms", "make_plan", "onesweep_pass", "finish_rows",
           "finish_index")


def read(run):
    if run.trace is None or run.probes is None:
        return None
    nbytes = sum(run.probes.per_job(run.probes.bytes, "sort", run.profiled))
    return roofline.share_pct(nbytes, run.trace.kernel_s(KERNELS),
                              run.device_kind)
