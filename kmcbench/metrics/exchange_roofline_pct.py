"""exchange_roofline_pct: the sharded finalize's exchange kernel's share
of its roofline over the traced jobs, in %: the bytes of each exchange
(roofline.exchange_bytes: every row's columns read once and written
once, from the rows each sender sends each owner; the program's
kmc.exchange "bytes" counter holds the same) at one card's peak memory
rate, over the device time of the kernel (exchange_tiles, the device
code of kmc_exchange_tiles) summed over the cards.

The bound is looser than the kernel table's in PERF.md, which takes the
rows that cross cards at NVLink's 450 GB/s: here every byte goes at the
HBM rate, so the share reads lower.  It cannot pass 100%: each card's
launch reads its own rows from its HBM and writes each once, to its own
HBM or over NVLink, so it lasts at least max((read + local write) /
3.35 TB/s, remote write / 450 GB/s), which is at least its rows' bytes
at 3.35 TB/s wherever 27% or more of a sender's rows cross cards
(2 x 450 / 3350); four owners of balanced bin ranges take about three
quarters of each sender's rows to another card."""

from kmcbench import roofline

KERNELS = ("exchange_tiles",)


def read(run):
    if run.trace is None or run.probes is None:
        return None
    nbytes = sum(run.probes.per_job(run.probes.bytes, "exchange",
                                    run.profiled))
    return roofline.share_pct(nbytes, run.trace.kernel_s(KERNELS),
                              run.device_kind)
