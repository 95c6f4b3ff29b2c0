"""ingest_roofline_pct: the fused ingest's share of its roofline over the
traced jobs: each call's bytes (roofline.ingest_bytes: the feed read
once, the rows written once) at the card's peak memory rate, over the
device time of its kernels (scan_kernel, delta_scan_kernel), in %."""

from kmcbench import roofline

KERNELS = ("scan_kernel", "delta_scan_kernel")


def read(run):
    if run.trace is None or run.probes is None:
        return None
    nbytes = sum(run.probes.per_job(run.probes.bytes, "ingest",
                                    run.profiled))
    return roofline.share_pct(nbytes, run.trace.kernel_s(KERNELS),
                              run.device_kind)
