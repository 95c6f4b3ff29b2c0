"""The yardstick of the kernels' roofline shares: the card's peak memory
rate and the bytes each kernel call must move.

A call's bytes are what its algorithm has to read once and write once
for its shapes, whatever implements it (the bounds of the port's
chip_smoke.py phases 2 and 3)."""
from __future__ import annotations

# device name (torch.cuda.get_device_name) -> peak device-memory bytes/s
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM data sheet
}


def peak_bytes_per_s(device_kind: str):
    """The card's peak memory rate, None for a card not in the table."""
    return PEAK_BYTES_PER_S.get(device_kind)


def ingest_bytes(feed_bytes: int, s: int, n_cols: int) -> int:
    """The fused ingest of one batch: its feed read once, and s rows of
    n_cols int32 columns (key columns, plus counts once the store has
    them) written once."""
    return int(feed_bytes) + 4 * int(s) * int(n_cols)


def sort_bytes(rows: int, n_cols: int) -> int:
    """One grouping sort: rows of n_cols int32 columns read once and
    written once."""
    return 2 * 4 * int(rows) * int(n_cols)


def exchange_bytes(counts, n_cols: int) -> int:
    """One exchange of the sharded finalize: counts[j][o] rows from sender
    j to owner o, each row n_cols int32 columns, read once and written
    once."""
    return 2 * 4 * int(n_cols) * int(sum(int(n) for row in counts
                                         for n in row))


def share_pct(nbytes: int, device_s: float, device_kind: str):
    """nbytes at the peak rate over the measured device seconds, in %;
    None where nothing was measured or the card's peak is unknown."""
    peak = peak_bytes_per_s(device_kind)
    if peak is None or not device_s or not nbytes:
        return None
    return 100.0 * nbytes / peak / device_s
